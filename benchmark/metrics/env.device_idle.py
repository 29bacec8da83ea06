"""The share of the traced env window (tabular training or greedy eval) in
which no operation ran on the card. The window is its length without the
profiler (:attr:`untraced_s`)."""


def read(s):
    if "spawns" not in s.counts:
        return None
    return 100.0 * (1.0 - s.busy_s / s.untraced_s)
