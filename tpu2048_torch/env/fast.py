"""Fast batched env on the env-step kernel, the port of
:mod:`tpu2048.env.fast` (simple and shaped reward modes).

Board state lives cell-major ``(16, B)`` on the device and each step is one
launch of :func:`tpu2048_torch.ops.step_kernel.fused_env_step`; the reward,
the terminal bonus, the shaped env's stall lanes and the episode lanes are a
few tensor ops outside it.

Randomness comes from an explicit bit source: a callable ``batch -> (8,
batch)`` int32 tensor of raw uint32 bit patterns, one draw per step.
:class:`GeneratorBits` draws them from a ``torch.Generator`` on the device;
:class:`ReplayBits` replays given rows (the tests feed it the bits the JAX
package draws). The JAX state's ``seed`` field, which keyed those draws,
therefore has no counterpart in :class:`FastEnvState`. The kernel's
random-legal pick (``_rand_legal_action`` in the JAX module) lives beside
the kernel, as :func:`tpu2048_torch.ops.step_kernel.rand_legal_action`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from tpu2048_torch.env import rewards as rw
from tpu2048_torch.env.env import SHAPED, SIMPLE
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops import step_kernel as sk


@dataclasses.dataclass(frozen=True)
class FastEnvConfig:
    """``tpu2048.env.fast.FastEnvConfig`` without its TPU knobs
    (``block_size``, ``interpret``, ``external_rng``, ``backend``).

    ``shaped`` selects the QLearningBase env (Game2048_env.py:78-205): the
    kernel runs the v1 done rule with the stall force-done, and the shaped
    reward, stall penalty and ``prev_max`` lanes are computed outside it.
    """

    terminal_bonus: bool = True
    shaped: bool = False
    max_consecutive_actions: int = 10  # Game2048_env.py:92
    stall_force_done: int = 100  # Game2048_env.py:123
    reset_shaping: bool = False  # EnvConfig.reset_shaping_on_reset


def for_env(env_config) -> FastEnvConfig:
    """The fast config of an :class:`~tpu2048_torch.env.env.EnvConfig` (the
    env-config part of ``tpu2048.env.fast.for_backend``): its terminal
    bonus, and for a SHAPED env its stall parameters."""
    shaped = {}
    if env_config.reward == SHAPED:
        shaped = dict(
            shaped=True,
            max_consecutive_actions=env_config.max_consecutive_actions,
            stall_force_done=env_config.stall_force_done,
            reset_shaping=env_config.reset_shaping_on_reset,
        )
    return FastEnvConfig(terminal_bonus=env_config.terminal_bonus, **shaped)


def resolve_engine(env_config, engine: str,
                   require_auto_reset: bool = True) -> str:
    """The fast-engine eligibility rule (``tpu2048.env.fast.resolve_engine``).

    The kernel implements the simple and shaped non-quirk, auto-resetting
    semantics. ``require_auto_reset=False`` is for the eval harness, which
    latches each board's first completion. "auto" picks "fast" when
    eligible; an explicit "fast" on an ineligible env raises.
    """
    fast_ok = (
        env_config.reward in (SIMPLE, SHAPED)
        and not env_config.quirk_compat
        and (env_config.auto_reset or not require_auto_reset)
    )
    if engine == "auto":
        return "fast" if fast_ok else "lax"
    if engine == "fast" and not fast_ok:
        raise ValueError(
            "engine='fast' requires non-quirk"
            + (", auto-reset" if require_auto_reset else "")
            + f" env semantics (got {env_config})"
        )
    if engine not in ("fast", "lax"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


class GeneratorBits:
    """Bit source for production: one ``torch.randint`` per step from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, batch: int) -> torch.Tensor:
        return torch.randint(
            -(2**31), 2**31, (8, batch), dtype=torch.int32,
            generator=self.generator, device=self.device,
        )


class ReplayBits:
    """Bit source that returns the given ``(8, B)`` rows in order."""

    def __init__(self, rows: Iterable[torch.Tensor]):
        self._rows = iter(rows)

    def __call__(self, batch: int) -> torch.Tensor:
        rows = next(self._rows)
        if tuple(rows.shape) != (8, batch) or rows.dtype != torch.int32:
            raise ValueError(
                f"replayed bits are {tuple(rows.shape)} {rows.dtype}, "
                f"expected (8, {batch}) torch.int32"
            )
        return rows


@dataclasses.dataclass
class FastEnvState:
    boards: torch.Tensor  # (16, B) int8 cell-major
    legal: torch.Tensor  # (B, 4) bool: legal moves of `boards`
    score: torch.Tensor  # (B,) int32 episode merge score
    episode_steps: torch.Tensor  # (B,) int32
    episode_return: torch.Tensor  # (B,) f32

    @property
    def batch_size(self) -> int:
        return self.boards.shape[1]


@dataclasses.dataclass
class ShapedFastEnvState(FastEnvState):
    """:class:`FastEnvState` and the shaped env's cross-episode lanes
    (Game2048_env.py:87,92-95): ``prev_max`` is the running best max tile
    VALUE (2 at start, not reset between episodes unless ``reset_shaping``);
    the consec lanes are the stall counters."""

    prev_max: torch.Tensor  # (B,) int32 tile value
    consec_action: torch.Tensor  # (B,) int32, -1 = none yet
    consec_count: torch.Tensor  # (B,) int32
    last_consec_penalty: torch.Tensor  # (B,) f32


@dataclasses.dataclass
class FastTimeStep:
    obs: torch.Tensor  # (16, B) int8: post-step board BEFORE auto-reset
    reward: torch.Tensor  # (B,) f32
    done: torch.Tensor  # (B,) bool
    valid: torch.Tensor  # (B,) bool
    merge_score: torch.Tensor  # (B,) int32
    max_number: torch.Tensor  # (B,) int32
    episode_return: torch.Tensor  # (B,) f32
    episode_steps: torch.Tensor  # (B,) int32


def fast_reset(bits, batch_size: int,
               config: Optional[FastEnvConfig] = None) -> FastEnvState:
    """Fresh boards from one draw of ``bits``, by the kernel's reset rule
    (rows 4-7), on the bit source's device (``tpu2048.env.fast.fast_reset``).
    A shaped ``config`` gives a :class:`ShapedFastEnvState`."""
    boards = sk.reset_boards(bits(batch_size))
    device = boards.device

    def full(value, dtype):
        return torch.full((batch_size,), value, dtype=dtype, device=device)

    common = dict(
        boards=sk.to_cell_major(boards),
        legal=board_ops.legal_moves_mask(boards),
        score=full(0, torch.int32),
        episode_steps=full(0, torch.int32),
        episode_return=full(0.0, torch.float32),
    )
    if config is not None and config.shaped:
        return ShapedFastEnvState(
            **common,
            prev_max=full(2, torch.int32),
            consec_action=full(-1, torch.int32),
            consec_count=full(0, torch.int32),
            last_consec_penalty=full(-1.0, torch.float32),
        )
    return FastEnvState(**common)


def _tile(exp: torch.Tensor) -> torch.Tensor:
    """int8 exponents -> int32 ``1 << exp``."""
    e = exp.to(torch.int32)
    return torch.ones_like(e) << e


def fast_step(
    config: FastEnvConfig,
    state: FastEnvState,
    bits,
    actions: Optional[torch.Tensor] = None,
    need_obs: bool = False,
    need_legal: bool = False,
) -> Tuple[FastEnvState, FastTimeStep]:
    """One step of the whole batch (``tpu2048.env.fast.fast_step``).

    ``actions=None`` plays the kernel's random-legal policy.
    ``need_obs=True`` also materializes the pre-reset board in the timestep;
    ``need_legal=True`` refreshes ``state.legal`` from the kernel (otherwise
    the field goes stale). A shaped ``config`` runs :func:`_shaped_fast_step`.
    """
    if config.shaped:
        return _shaped_fast_step(config, state, bits, actions, need_obs,
                                 need_legal)
    b = state.batch_size
    device = state.boards.device
    if actions is None:
        actions = torch.full((b,), -1, dtype=torch.int32, device=device)
    outs = sk.fused_env_step(
        state.boards, actions, bits(b),
        emit_pre_reset=need_obs, emit_legal=need_legal,
    )
    new_boards, merge_score, valid, done, max_exp, second_exp = outs[:6]
    obs = outs[6] if need_obs else new_boards
    legal = (outs[-1] != 0).T if need_legal else state.legal

    # Simple reward (done = game over in simple mode) + the training loop's
    # terminal bonus on the kernel's top two tiles.
    reward = rw.simple_reward(merge_score, valid, done)
    if config.terminal_bonus:
        top2 = torch.stack([_tile(max_exp),
                            torch.where(second_exp > 0, _tile(second_exp), 0)],
                           dim=-1)
        reward = reward + rw.terminal_bonus(top2, done)

    episode_return = state.episode_return + reward
    episode_steps = state.episode_steps + 1
    score = state.score + merge_score
    ts = FastTimeStep(
        obs=obs,
        reward=reward,
        done=done,
        valid=valid,
        merge_score=merge_score,
        max_number=torch.where(max_exp > 0, _tile(max_exp), 0),
        episode_return=episode_return,
        episode_steps=episode_steps,
    )
    new_state = FastEnvState(
        boards=new_boards,
        legal=legal,
        score=torch.where(done, 0, score),
        episode_steps=torch.where(done, 0, episode_steps),
        episode_return=torch.where(done, 0.0, episode_return),
    )
    return new_state, ts


def _shaped_fast_step(config: FastEnvConfig, state: ShapedFastEnvState, bits,
                      actions, need_obs: bool, need_legal: bool):
    """Shaped-reward fast step (``tpu2048.env.fast._shaped_fast_step``).

    The stall counter and ``force_done`` are computed from the action
    stream before the kernel; the kernel runs the v1 done rule
    ``(~moved & game_over) | force_done``; the shaped reward, the stall
    penalty ladder and ``prev_max`` follow it.
    """
    if actions is None:
        raise ValueError(
            "the shaped fast env requires explicit actions: its stall "
            "counters (Game2048_env.py:110-127) are a function of the "
            "action stream, which the in-kernel random policy never exposes"
        )
    b = state.batch_size
    same = actions == state.consec_action
    consec_count = torch.where(same, state.consec_count + 1, 1)
    force_done = consec_count > config.stall_force_done

    outs = sk.fused_env_step(
        state.boards, actions, bits(b), force_done,
        emit_pre_reset=need_obs, emit_legal=need_legal,
    )
    (new_boards, merge_score, valid, done, max_exp, second_exp,
     game_over) = outs[:7]
    obs = outs[7] if need_obs else new_boards
    legal = (outs[-1] != 0).T if need_legal else state.legal

    max_number = torch.where(max_exp > 0, _tile(max_exp), 0)
    reward, new_prev_max = rw.shaped_reward(merge_score, valid, game_over,
                                            max_number, state.prev_max)
    last_penalty = torch.where(same, state.last_consec_penalty, -1.0)
    stalled = consec_count > config.max_consecutive_actions
    penalty = torch.clamp_min(last_penalty * 1.1, -10.0)
    last_penalty = torch.where(stalled, penalty, last_penalty)
    reward = reward + torch.where(stalled, penalty, 0.0)

    episode_return = state.episode_return + reward
    episode_steps = state.episode_steps + 1
    score = state.score + merge_score
    ts = FastTimeStep(
        obs=obs,
        reward=reward,
        done=done,
        valid=valid,
        merge_score=merge_score,
        max_number=max_number,
        episode_return=episode_return,
        episode_steps=episode_steps,
    )
    # Episode lanes clear on done; the shaping lanes persist across episodes
    # (Game2048_env.py:187-191) unless reset_shaping.
    consec_action = actions
    if config.reset_shaping:
        new_prev_max = torch.where(done, 2, new_prev_max)
        consec_action = torch.where(done, -1, consec_action)
        consec_count = torch.where(done, 0, consec_count)
        last_penalty = torch.where(done, -1.0, last_penalty)
    new_state = ShapedFastEnvState(
        boards=new_boards,
        legal=legal,
        score=torch.where(done, 0, score),
        episode_steps=torch.where(done, 0, episode_steps),
        episode_return=torch.where(done, 0.0, episode_return),
        prev_max=new_prev_max,
        consec_action=consec_action,
        consec_count=consec_count,
        last_consec_penalty=last_penalty,
    )
    return new_state, ts
