"""The bucket gather's share of its roofline in the traced chunk: its
bytes (a 512-byte row read and written, and an id read, a lane a call) at
the HBM rate over its device time."""

from benchmark.counts import kernels as K


def read(s):
    c = s.counts
    if "gathers" not in c:
        return None
    t = s.kernel_time_s(K.is_gather)
    return 100.0 * K.bucket_bound_s(c["gathers"], c["lanes"]) / t \
        if t > 0 else None
