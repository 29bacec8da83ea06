"""The port's hand-written kernels as the profiler names them, and their
least times at the card's peaks."""

import re

from benchmark.counts import peaks, step_ops, table_bytes


def _named(kernel):
    pattern = re.compile(r"^(\(anonymous namespace\)::)?%s\(" % kernel)
    return lambda name: bool(pattern.match(name))


# csrc/step_kernel.cu's step_kernel and csrc/table_kernel.cu's kernels, in
# an anonymous namespace.
is_step = _named("step_kernel")
is_gather = _named("gather_kernel")
is_scatter = _named("scatter_kernel")


def step_bound_s(c):
    """The step kernel's least time in the traced window: its operations
    for the window's lane-steps, spawns and resets at the integer peak."""
    ops = step_ops.step_kernel_ops(c["lane_steps"], c["spawns"],
                                   c["resets"], c["emit_legal"])
    return ops / peaks.int_ops_per_s(c["sm_count"], c["sm_clock_hz"])


def bucket_bound_s(calls, lanes):
    """``calls`` gathers or scatters of ``lanes`` rows at the HBM rate."""
    return calls * table_bytes.bucket_call_bytes(lanes) \
        / peaks.HBM_BYTES_PER_S
