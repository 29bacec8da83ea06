"""The traced play window's share of the card's bf16 dense peak: one
forward at batch 1 a move, over the window. The window is its length
without the profiler (:attr:`untraced_s`)."""

from benchmark.counts import peaks


def read(s):
    c = s.counts
    if "lane_steps" in c or "moves" not in c:
        return None
    return 100.0 * c["moves"] * c["forward_flops"] / (
        s.untraced_s * peaks.BF16_FLOPS_PER_S)
