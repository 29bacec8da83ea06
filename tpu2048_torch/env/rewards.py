"""Reward functions, the port of :mod:`tpu2048.env.rewards`.

* :func:`shaped_reward`: the QLearningBase env's level-progress reward with
  signed log2 normalization (:func:`normalize_reward`).
* :func:`simple_reward`: -10 for an invalid non-terminal move, else the raw
  merge score.
* :func:`terminal_bonus` on :func:`top2_tile_values`: +100 at a 2048 tile,
  +50 for two 1024s.

All take and return batched tensors. ``log2`` and ``level ** 1.2`` are
float32 transcendental functions, which torch and XLA may round one ulp
apart; the tests hold the shaped reward to ``2e-6 * max(1, |r|)``.
"""

from __future__ import annotations

import torch

SCALING_FACTOR = 1.2


def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(x.to(torch.float32))


def normalize_reward(reward: torch.Tensor) -> torch.Tensor:
    """``r >= 0 -> min(log2(r + 1), 10)``; ``r < 0 -> -min(log2(|r - 1|),
    10)``."""
    pos = torch.clamp_max(_log2(reward + 1.0), 10.0)
    neg = -torch.clamp_max(_log2(torch.abs(reward - 1.0)), 10.0)
    return torch.where(reward >= 0, pos, neg)


def shaped_reward(score, valid, game_over, max_number, prev_max):
    """Level-progress shaped reward (``rewards.shaped_reward``).

    Args are ``(B,)``: int32 merge score, bool valid, bool game over on the
    post-move board, int32 max tile value, int32 running best max tile
    (not reset between episodes by default).

    Returns ``(reward, new_prev_max)``: normalized float32 reward and the
    updated running max.
    """
    score = score.to(torch.float32)
    max_number = torch.clamp_min(max_number, 2)
    level = _log2(max_number)
    level_pow = level ** SCALING_FACTOR

    improved = max_number > prev_max
    bonus_progress = torch.where(
        improved, (level - _log2(torch.clamp_min(prev_max, 1))) * level_pow,
        0.0)
    new_prev_max = torch.where(improved, max_number, prev_max)

    is_exact_milestone = ((max_number == 512) | (max_number == 1024)
                          | (max_number == 2048))
    invalid_terminal = torch.where(is_exact_milestone,
                                   bonus_progress + level_pow,
                                   -_log2(max_number + 1))
    invalid_nonterminal = -0.1 * level
    invalid_reward = torch.where(game_over, invalid_terminal,
                                 invalid_nonterminal)

    valid_reward = (
        score
        + torch.where(bonus_progress > 0, bonus_progress, level * 0.05)
        + torch.where(max_number >= 512, level_pow * 2.0, 0.0)
    )
    reward = torch.where(valid, valid_reward, invalid_reward)
    return normalize_reward(reward), new_prev_max


def simple_reward(score, valid, game_over) -> torch.Tensor:
    """``-10`` when the move is invalid and the game is not over, else the
    raw merge score."""
    return torch.where(~valid & ~game_over, -10.0, score.to(torch.float32))


def terminal_bonus(board_values_sorted_top2, done) -> torch.Tensor:
    """+100 when the final max tile >= 2048; +50 when it is >= 1024 and the
    second-largest tile is too; else 0. Only on ``done``.

    ``board_values_sorted_top2`` is ``(B, 2)`` int32 (max, second max).
    """
    final = board_values_sorted_top2[..., 0]
    semi = board_values_sorted_top2[..., 1]
    bonus = torch.where(final >= 2048, 100.0,
                        torch.where((final >= 1024) & (semi >= 1024), 50.0,
                                    0.0))
    return torch.where(done, bonus, 0.0).to(torch.float32)


def top2_tile_values(board: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` int32 (max, second max) tile values of ``(..., 4, 4)``
    boards; duplicates count, so two 1024s give (1024, 1024)."""
    exp = board.reshape(*board.shape[:-2], 16).to(torch.int32)
    vals = torch.where(exp > 0, torch.ones_like(exp) << exp, 0)
    m1 = vals.amax(-1)
    is_max = vals == m1.unsqueeze(-1)
    first_max = is_max.to(torch.int32).cumsum(-1) == 1
    masked = torch.where(is_max & first_max, -1, vals)
    m2 = masked.amax(-1).clamp_min(0)
    return torch.stack([m1, m2], dim=-1)
