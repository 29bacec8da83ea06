"""The afterstate kernel's share of its roofline in the traced steps: its
useful bytes (``counts/ntuple_bytes.py``: 4 a lookup, and the boards and
flags read and the outputs written) at the HBM rate over its device time."""

from benchmark.counts import ntuple_bytes as N


def read(s):
    c = s.counts
    if "legal_moves" not in c:
        return None
    t = s.kernel_time_s(N.is_value)
    n = N.value_bytes(c["lane_steps"], c["legal_moves"], c["prev_lanes"],
                      c["lookups"])
    return 100.0 * N.bound_s(n) / t if t > 0 else None
