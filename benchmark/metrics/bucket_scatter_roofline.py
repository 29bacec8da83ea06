"""The bucket scatter's share of its roofline in the traced chunk: its
bytes (a 512-byte row read and written into the table, and an id read, a
lane a call) at the HBM rate over its device time."""

from benchmark.counts import kernels as K


def read(s):
    c = s.counts
    if "scatters" not in c:
        return None
    t = s.kernel_time_s(K.is_scatter)
    return 100.0 * K.bucket_bound_s(c["scatters"], c["lanes"]) / t \
        if t > 0 else None
