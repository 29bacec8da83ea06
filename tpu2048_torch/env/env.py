"""Environment configuration, the part of :mod:`tpu2048.env.env` that the
fast engine's eligibility rule and the evaluation harness read."""

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

    def __post_init__(self):
        if self.reward not in (SHAPED, SIMPLE):
            raise ValueError(f"unknown reward variant {self.reward!r}")
