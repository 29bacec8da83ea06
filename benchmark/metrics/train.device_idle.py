"""The share of the traced training window in which no operation ran on the
card. The window is its length without the profiler
(:attr:`untraced_s`)."""


def read(s):
    if "updates" not in s.counts or not s.untraced_s:
        return None
    return 100.0 * (1.0 - s.busy_s / s.untraced_s)
