"""Fast batched env on the env-step kernel, the port of
:mod:`tpu2048.env.fast` (simple-reward mode).

Board state lives cell-major ``(16, B)`` on the device and each step is one
launch of :func:`tpu2048_torch.ops.step_kernel.fused_env_step`; the simple
reward, the terminal bonus and the episode lanes are a few tensor ops
outside it.

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

from tpu2048_torch.env.env import SHAPED, SIMPLE
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops import step_kernel as sk


@dataclasses.dataclass(frozen=True)
class FastEnvConfig:
    """``tpu2048.env.fast.FastEnvConfig`` without its TPU knobs
    (``block_size``, ``interpret``, ``external_rng``, ``backend``)."""

    terminal_bonus: bool = True
    shaped: bool = False

    def __post_init__(self):
        if self.shaped:
            raise NotImplementedError(
                "the shaped-reward fast env is not yet ported"
            )


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
class FastTimeStep:
    obs: torch.Tensor  # (16, B) int8: post-step board BEFORE auto-reset
    reward: torch.Tensor  # (B,) f32
    done: torch.Tensor  # (B,) bool
    valid: torch.Tensor  # (B,) bool
    merge_score: torch.Tensor  # (B,) int32
    max_number: torch.Tensor  # (B,) int32
    episode_return: torch.Tensor  # (B,) f32
    episode_steps: torch.Tensor  # (B,) int32


def fast_reset(bits, batch_size: int) -> FastEnvState:
    """Fresh boards from one draw of ``bits``, by the kernel's reset rule
    (rows 4-7), on the bit source's device (``tpu2048.env.fast.fast_reset``,
    whose ``config`` only chose the shaped state, not yet ported)."""
    boards = sk.reset_boards(bits(batch_size))
    device = boards.device
    return FastEnvState(
        boards=sk.to_cell_major(boards),
        legal=board_ops.legal_moves_mask(boards),
        score=torch.zeros(batch_size, dtype=torch.int32, device=device),
        episode_steps=torch.zeros(batch_size, dtype=torch.int32, device=device),
        episode_return=torch.zeros(batch_size, dtype=torch.float32,
                                   device=device),
    )


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
    the field goes stale).
    """
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

    # Simple reward (nopenalty:122-138) + the training loop's terminal bonus
    # (mainDQL:202-213).
    reward = torch.where(~valid & ~done, -10.0, merge_score.to(torch.float32))
    if config.terminal_bonus:
        max_val = _tile(max_exp)
        sec_val = torch.where(second_exp > 0, _tile(second_exp), 0)
        bonus = torch.where(
            max_val >= 2048, 100.0,
            torch.where((max_val >= 1024) & (sec_val >= 1024), 50.0, 0.0),
        )
        reward = reward + torch.where(done, bonus, 0.0)

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
