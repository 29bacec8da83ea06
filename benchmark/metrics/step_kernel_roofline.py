"""The env-step kernel's share of its roofline in the traced window: its
least time (32-bit operations of the window's lane-steps, spawns and
resets at the card's integer peak) over its device time."""

from benchmark.counts import kernels as K


def read(s):
    c = s.counts
    if "spawns" not in c or "sm_count" not in c:
        return None
    t = s.kernel_time_s(K.is_step)
    return 100.0 * K.step_bound_s(c) / t if t > 0 else None
