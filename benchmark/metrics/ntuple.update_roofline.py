"""The TD-update kernel's share of its roofline in the traced steps: its
useful bytes (``counts/ntuple_bytes.py``: a weight's read and write, the
hit count's increment, read and reset a lookup, and the lane's inputs) at
the HBM rate over the device time of its three phases."""

from benchmark.counts import ntuple_bytes as N


def read(s):
    c = s.counts
    if "prev_lanes" not in c:
        return None
    t = s.kernel_time_s(N.is_update)
    n = N.update_bytes(c["lane_steps"], c["prev_lanes"], c["lookups"])
    return 100.0 * N.bound_s(n) / t if t > 0 else None
