"""Trajectory-parity harness against the reference envs, the port of
:mod:`tpu2048.env.parity`.

Drives the original reference environment as an oracle, reads each step's
random spawn off the boards (the oracle's post-board against the
deterministic merge), feeds that decision into the port's
:func:`tpu2048_torch.env.env.step_with_spawn`, and checks that the board,
reward, done and max-tile sequences match. Whatever host randomness the
oracle consumed (its legality probes draw from ``np.random``,
Game2048_nopenalty_env.py:68-78), its effect is observed and replayed.

The reference is read, never copied, from a checkout of its repository
named by the ``TPU2048_REFERENCE`` environment variable (or the ``root``
argument): ``QLearningBase/environment`` holds the v1 (shaped) env and
``Deep_QLearning/environment`` the v2 (simple) env.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tpu2048_torch.env import env as envlib
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.utils.device import resolve_device

REFERENCE_VAR = "TPU2048_REFERENCE"
V1_SUBDIR = os.path.join("QLearningBase", "environment")
V2_SUBDIR = os.path.join("Deep_QLearning", "environment")


def load_reference_env(variant: str, root: Optional[str] = None):
    """Import the reference Gym env class (v1 shaped, v2 simple) from the
    checkout at ``root`` (default: ``$TPU2048_REFERENCE``)."""
    if variant not in ("v1", "v2"):
        raise ValueError(variant)
    root = root or os.environ.get(REFERENCE_VAR)
    if not root:
        raise FileNotFoundError(
            f"no reference checkout: set {REFERENCE_VAR} to the directory "
            "of the original repository")
    directory = os.path.join(root, V1_SUBDIR if variant == "v1"
                             else V2_SUBDIR)
    if directory not in sys.path:
        sys.path.insert(0, directory)
    if variant == "v1":
        import Game2048_env as mod  # noqa: PLC0415
    else:
        import Game2048_nopenalty_env as mod  # noqa: PLC0415
    return mod.Game2048_env


@dataclass
class ParityResult:
    steps: int
    done: bool
    mismatches: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


def _extract_spawn(visible_merged_values: np.ndarray, post_values: np.ndarray):
    """Diff the oracle's post-board against the deterministic merge result.

    Returns ``(empty_idx, val_exponent)`` of the spawned tile, or ``(0, 0)``
    if no tile spawned (an invalid move).
    """
    diff = (post_values.astype(np.int64)
            - visible_merged_values.astype(np.int64))
    nz = np.argwhere(diff != 0)
    if len(nz) == 0:
        return 0, 0
    if len(nz) != 1:
        raise ValueError(f"expected a single spawn cell, got {nz}")
    r, c = nz[0]
    val = int(post_values[r, c])
    if val not in (2, 4) or visible_merged_values[r, c] != 0:
        raise ValueError(f"unexpected spawn of {val} at ({r}, {c})")
    flat = r * 4 + c
    empties_before = int((visible_merged_values.reshape(-1)[:flat] == 0).sum())
    return empties_before, 1 if val == 2 else 2


def _values(board) -> np.ndarray:
    return board_ops.board_values(board).cpu().numpy()


def run_parity(
    variant: str,
    seed: int,
    max_steps: int = 400,
    action_seed: int = 0,
    reward_atol: float = 2e-4,
    device=None,
) -> ParityResult:
    """Run one seeded episode on the reference env and replay it on the
    port's env, on ``device`` (``cuda`` unless another is named).

    Args:
      variant: "v1" (shaped reward, QLearningBase) or "v2" (simple reward,
        Deep_QLearning, replayed with ``quirk_compat=True`` and the
        driver's manual board commit, mainDQL:237).
      seed: ``np.random.seed`` for the oracle's spawn stream.
      max_steps: cap on the episode's length.
      action_seed: seed of the (separate) action stream.
      reward_atol: reward tolerance, relative to max(1, |reward|).

    Returns:
      :class:`ParityResult` with any mismatches described.
    """
    RefEnv = load_reference_env(variant)
    np.random.seed(seed)
    ref = RefEnv()
    device = resolve_device(device)

    config = envlib.EnvConfig(
        reward=envlib.SHAPED if variant == "v1" else envlib.SIMPLE,
        terminal_bonus=False,
        auto_reset=False,
        quirk_compat=(variant == "v2"),
    )
    # The oracle's initial board, as the fresh board of a one-lane reset.
    first = board_ops.values_to_exponents(np.array(ref.game.board))
    state = envlib.reset(config, envlib.ReplaySpawns(
        [], [first[None].to(device)]), 1)

    actions = np.random.RandomState(action_seed)
    result = ParityResult(steps=0, done=False)

    for t in range(max_steps):
        action = int(actions.randint(0, 4))
        pre_values = np.asarray(ref.game.board).copy()

        ref_obs, ref_reward, ref_done, ref_max = ref.step(action)
        ref_obs = np.asarray(ref_obs)
        if variant == "v2":
            # The reference driver commits moved_board itself
            # (mainDQL_CNN_step2.py:237).
            ref.game.board = ref_obs.copy()

        # The deterministic merge of the visible board, with the v2
        # full-board probe clobber that quirk_compat reproduces.
        pre_exp = board_ops.values_to_exponents(pre_values)
        merged, _, _ = board_ops.move(pre_exp, action)
        visible = _values(merged)
        if variant == "v2":
            pre_legal = board_ops.legal_moves_mask(pre_exp).numpy()
            if (pre_values != 0).all() and pre_legal.any():
                first_legal = int(np.argmax(pre_legal))
                visible = _values(board_ops.move(pre_exp, first_legal)[0])
        spawn_idx, spawn_val = _extract_spawn(visible, ref_obs)

        state, ts = envlib.step_with_spawn(
            config, state,
            torch.tensor([action], dtype=torch.int32, device=device),
            torch.tensor([spawn_idx], dtype=torch.int32, device=device),
            torch.tensor([spawn_val], dtype=torch.int8, device=device),
        )
        result.steps = t + 1

        our_board = _values(ts.obs[0])
        reward = float(ts.reward[0])
        if not np.array_equal(our_board, ref_obs):
            result.mismatches.append(
                f"step {t}: board mismatch\nours:\n{our_board}\n"
                f"ref:\n{ref_obs}")
            break
        if abs(reward - float(ref_reward)) > reward_atol * max(
                1.0, abs(float(ref_reward))):
            result.mismatches.append(
                f"step {t}: reward {reward} != {float(ref_reward)}")
        if bool(ts.done[0]) != bool(ref_done):
            result.mismatches.append(
                f"step {t}: done {bool(ts.done[0])} != {bool(ref_done)}")
            break
        if int(ts.max_number[0]) != int(ref_max):
            result.mismatches.append(
                f"step {t}: max {int(ts.max_number[0])} != {int(ref_max)}")
        if bool(ref_done):
            result.done = True
            break
    return result
