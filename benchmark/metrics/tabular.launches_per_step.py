"""Kernels the card ran a tabular training step in the traced chunk (the
env-step kernel, the bucket gathers and scatter, and every eager op's
kernels), copies and fills left out."""


def read(s):
    steps = s.counts.get("steps")
    if not steps or "gathers" not in s.counts:
        return None
    return s.kernel_count() / steps
