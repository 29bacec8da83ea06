"""The share of rank 0's untraced window that its NCCL kernels (the
gradient all-reduce and the step's small count reductions) held the card:
their device time in rank 0's trace over the traced part's length at the
untraced pace; None where the trace holds none (gloo ranks on the CPU)."""


def read(s):
    c = s.counts
    if "ranks" not in c or not s.untraced_s:
        return None
    t = s.kernel_time_s(lambda name: "nccl" in name.lower())
    return 100.0 * t / s.untraced_s if t > 0 else None
