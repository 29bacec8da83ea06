"""Environment configuration, the part of :mod:`tpu2048.env.env` that the
fast engine, its eligibility rule, the trainers and the evaluation harness
read."""

from __future__ import annotations

import dataclasses

SHAPED = "shaped"
SIMPLE = "simple"


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (``tpu2048.env.env.EnvConfig``)."""

    reward: str = SIMPLE  # "shaped" (QLearningBase) or "simple" (Deep_QLearning)
    terminal_bonus: bool = False  # training-loop shaping, mainDQL:202-213
    auto_reset: bool = True
    quirk_compat: bool = False  # reproduce v2 pre-move game_over + probe clobber
    reset_shaping_on_reset: bool = False  # reset prev_max/stall counters on reset
    # Stall handling (shaped env only, Game2048_env.py:92-95,110-127).
    max_consecutive_actions: int = 10
    stall_force_done: int = 100

    def __post_init__(self):
        if self.reward not in (SHAPED, SIMPLE):
            raise ValueError(f"unknown reward variant {self.reward!r}")
