"""Operations of the env-step kernel (``csrc/step_kernel.cu``), counted
at source level as 32-bit operations a lane: legality of the four
directions, the chosen merge, game over and the two maxima on every lane;
the next board's legal mask where the caller asks for it; the spawn where
the move changed the board and the reset where the episode ended. The
selects that gather a row into slide order are the design's cost, not the
function's work, and are not counted."""

from __future__ import annotations

OPS_LANE, OPS_LEGAL, OPS_SPAWN, OPS_RESET = 916, 352, 116, 76


def step_kernel_ops(lane_steps: int, spawns: int, resets: int,
                    emit_legal: bool) -> int:
    return (lane_steps * (OPS_LANE + OPS_LEGAL * emit_legal)
            + spawns * OPS_SPAWN + resets * OPS_RESET)
