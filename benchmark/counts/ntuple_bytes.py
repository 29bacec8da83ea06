"""Useful bytes of the n-tuple network's kernels (``csrc/ntuple_kernel.cu``),
and their names as the profiler gives them.

The afterstate kernel reads a lane's board, its previous afterstate and two
flags, and 4 bytes a lookup of each legal afterstate and of the previous
afterstate where there is one; it writes the four afterstates (64 bytes),
their rewards, legality and values, the previous afterstate's value, the
action, the target and the chosen afterstate. The TD-update kernel reads a
lane's flag, and for a lane with a previous afterstate its board, value
and target, and for each of its lookups counts the hit (a 4-byte read and
write), reads the count and adds to the weight (a 4-byte read and write)
and sets the count back (a 4-byte write). Each byte is counted once, as
the work needs it: a 32-byte sector that a gather pulls for 4 useful bytes,
or a read that the L2 serves, is not counted, so a share cannot pass 100%.
"""

from __future__ import annotations

import re

from benchmark.counts import peaks

VALUE_LANE_BYTES = 16 + 16 + 1 + 1 + 64 + 16 + 4 + 16 + 4 + 4 + 4 + 16
UPDATE_LANE_BYTES = 16 + 4 + 4
UPDATE_LOOKUP_BYTES = 8 + 4 + 8 + 4
WEIGHT_BYTES = 4


def _named(kernel):
    pattern = re.compile(r"^(\(anonymous namespace\)::)?%s\(" % kernel)
    return lambda name: bool(pattern.match(name))


is_value = _named("afterstate_kernel")
is_update = _named("td_update_kernel")


def value_bytes(lane_steps: int, legal_moves: int, prev_lanes: int,
                lookups: int) -> int:
    """Bytes of the afterstate kernel over ``lane_steps`` lanes, which
    evaluated ``legal_moves`` legal afterstates and ``prev_lanes`` previous
    afterstates of ``lookups`` lookups each."""
    return (lane_steps * VALUE_LANE_BYTES
            + (legal_moves + prev_lanes) * lookups * WEIGHT_BYTES)


def update_bytes(lane_steps: int, prev_lanes: int, lookups: int) -> int:
    """Bytes of the TD update over ``lane_steps`` lanes, of which
    ``prev_lanes`` had a previous afterstate to update."""
    return (lane_steps + prev_lanes * (UPDATE_LANE_BYTES
                                       + lookups * UPDATE_LOOKUP_BYTES))


def bound_s(n_bytes: int) -> float:
    """The least time of ``n_bytes`` at the HBM rate."""
    return n_bytes / peaks.HBM_BYTES_PER_S
