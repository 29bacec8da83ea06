"""The share of the traced play window in which no operation ran on the
card. The window is its length without the profiler
(:attr:`untraced_s`)."""


def read(s):
    c = s.counts
    if "lane_steps" in c or "moves" not in c:
        return None
    return 100.0 * (1.0 - s.busy_s / s.untraced_s)
