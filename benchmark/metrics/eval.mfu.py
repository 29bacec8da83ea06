"""The traced eval call's share of the card's bf16 dense peak in useful
model work: one forward a move the games made (a finished lane's forward
is no move), over the window. The window is its length without the
profiler (:attr:`untraced_s`)."""

from benchmark.counts import peaks


def read(s):
    c = s.counts
    if "lane_steps" not in c or "forward_flops" not in c:
        return None
    return 100.0 * c["moves"] * c["forward_flops"] / (
        s.untraced_s * peaks.BF16_FLOPS_PER_S)
