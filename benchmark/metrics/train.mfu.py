"""The traced window's share of the card's bf16 dense peak in the DQN's own
floating-point work: four forwards a board of each learner update's
batch (train forward, backward at twice its work, target forward) and
one a lane of each vector step's actor. The window is its length without
the profiler (:attr:`untraced_s`)."""

from benchmark.counts import peaks


def read(s):
    c = s.counts
    if "updates" not in c or not s.untraced_s:
        return None
    work = (c["updates"] * c["update_flops"]
            + c["vector_steps"] * c["envs"] * c["forward_flops"])
    return 100.0 * work / (s.untraced_s * peaks.BF16_FLOPS_PER_S)
