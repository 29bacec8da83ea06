"""The classic batched 2048 env, the port of :mod:`tpu2048.env.env`.

An :class:`EnvConfig` and plain ``reset``/``step`` functions over an
:class:`EnvState` of ``(B, ...)`` tensors; every lane steps in lockstep with
no host control flow. This is the op-by-op env (the "lax" engine): plain
tensor ops, no hand-written kernel. The fast engine's eligibility rule and
the trainers read :class:`EnvConfig` too.

Reference quirks and how they are handled, as in the JAX module:

* v2's ``game_over`` is computed on the PRE-move board, and when that board
  is full but playable the probe loop of ``is_game_over`` leaves the first
  legal probe move plus a spawn as the returned board (nopenalty:68-78,
  109, 120). ``EnvConfig.quirk_compat=True`` reproduces it; by default
  game over is read on the post-move board and nothing is clobbered.
* v1's ``reset`` keeps ``previous_max`` and the stall counters
  (Game2048_env.py:187-191); ``reset_shaping_on_reset=True`` resets them.

Randomness is explicit. JAX keys each lane's spawn with its own PRNG key
leaf, which torch cannot reproduce, so ``reset`` and ``step`` take a draw
source instead: ``source.spawn(board)`` returns the spawn decisions for the
``(B, 4, 4)`` boards the tiles land on (asked once the landing board is
known, so that quirk mode stays uniform over the probe's empties), and
``source.fresh(batch)`` returns fresh two-tile boards. :class:`GeneratorSpawns`
draws both from one ``torch.Generator`` on the env's device;
:class:`ReplaySpawns` hands back given decisions and boards (the tests feed
it JAX's). The per-lane ``rng`` leaf of JAX's state therefore has no field
here: the source holds that state, and a checkpoint saves its generator.

Action encoding: 0=left, 1=up, 2=right, 3=down (Game2048_env.py:54).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import torch

from tpu2048_torch.env import rewards as rw
from tpu2048_torch.ops import board as board_ops

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


@dataclasses.dataclass
class EnvState:
    """Batched env state; every field has leading dim B."""

    board: torch.Tensor  # (B, 4, 4) int8 exponents
    score: torch.Tensor  # (B,) int32 cumulative episode merge score
    move_score: torch.Tensor  # (B,) int32 last move's merge score
    prev_max: torch.Tensor  # (B,) int32 running best max tile (shaped)
    consec_action: torch.Tensor  # (B,) int32 last action (-1 = none)
    consec_count: torch.Tensor  # (B,) int32 consecutive same-action count
    last_consec_penalty: torch.Tensor  # (B,) f32 growing stall penalty
    episode_return: torch.Tensor  # (B,) f32 cumulative reward this episode
    episode_steps: torch.Tensor  # (B,) int32 steps this episode
    done: torch.Tensor  # (B,) bool the last step ended the episode

    @property
    def batch_size(self) -> int:
        return self.board.shape[0]


@dataclasses.dataclass
class TimeStep:
    """Per-step outputs, before the auto-reset, so that terminal
    information is observable."""

    obs: torch.Tensor  # (B, 4, 4) int8 board after the step
    reward: torch.Tensor  # (B,) f32
    done: torch.Tensor  # (B,) bool
    max_number: torch.Tensor  # (B,) int32 max tile value
    valid: torch.Tensor  # (B,) bool the move changed the board
    merge_score: torch.Tensor  # (B,) int32 raw merge score of the move
    legal_mask: torch.Tensor  # (B, 4) bool legal moves on the NEW board
    episode_return: torch.Tensor  # (B,) f32 return incl. this step
    episode_steps: torch.Tensor  # (B,) int32 length incl. this step


class GeneratorSpawns:
    """Draw source for production: ``torch.rand`` from one
    ``torch.Generator`` seeded with ``seed`` on ``device``; two uniforms a
    lane for a spawn, four for a fresh board."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.device)

    def spawn(self, board: torch.Tensor):
        u = self._uniform((2, board.shape[0]))
        return board_ops.sample_spawn(board, u[0], u[1])

    def fresh(self, batch: int) -> torch.Tensor:
        u = self._uniform((4, batch))
        return board_ops.init_board(u[:2], u[2:])


class ReplaySpawns:
    """Draw source that returns the given ``(empty_idx, val)`` spawn
    decisions (``(B,)`` int32 and int8) and fresh ``(B, 4, 4)`` int8
    boards, each in order."""

    def __init__(self, spawns: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                 fresh: Iterable[torch.Tensor]):
        self._spawns = iter(spawns)
        self._fresh = iter(fresh)

    def spawn(self, board: torch.Tensor):
        idx, val = next(self._spawns)
        b = board.shape[0]
        if (tuple(idx.shape) != (b,) or idx.dtype != torch.int32
                or tuple(val.shape) != (b,) or val.dtype != torch.int8):
            raise ValueError(
                f"replayed spawns are {tuple(idx.shape)} {idx.dtype} / "
                f"{tuple(val.shape)} {val.dtype}, expected ({b},) "
                "torch.int32 / torch.int8")
        return idx, val

    def fresh(self, batch: int) -> torch.Tensor:
        boards = next(self._fresh)
        if tuple(boards.shape) != (batch, 4, 4) or boards.dtype != torch.int8:
            raise ValueError(
                f"replayed boards are {tuple(boards.shape)} {boards.dtype}, "
                f"expected ({batch}, 4, 4) torch.int8")
        return boards


def reset(config: EnvConfig, source, batch_size: int) -> EnvState:
    """A fresh batched state: boards from ``source.fresh``, on their
    device. ``config`` is taken for the JAX signature's sake."""
    board = source.fresh(batch_size)
    device = board.device

    def full(value, dtype):
        return torch.full((batch_size,), value, dtype=dtype, device=device)

    return EnvState(
        board=board,
        score=full(0, torch.int32),
        move_score=full(0, torch.int32),
        prev_max=full(2, torch.int32),
        consec_action=full(-1, torch.int32),
        consec_count=full(0, torch.int32),
        last_consec_penalty=full(-1.0, torch.float32),
        episode_return=full(0.0, torch.float32),
        episode_steps=full(0, torch.int32),
        done=full(False, torch.bool),
    )


def step(config: EnvConfig, state: EnvState, action: torch.Tensor,
         source) -> Tuple[EnvState, TimeStep]:
    """Advance every lane by one action, spawning from ``source``; with
    ``config.auto_reset`` finished lanes restart on ``source.fresh``
    boards (drawn for every lane, as JAX draws them)."""
    candidates = board_ops.move_all(state.board)
    merged, merge_score, valid = board_ops.select_move(*candidates, action)
    quirk_pre = None
    landing = merged
    if config.reward == SIMPLE and config.quirk_compat:
        # The spawn can land on the probe board, whose empties differ from
        # the merged board's: draw the index from the board spawned onto.
        quirk_pre = _quirk_probe(state.board, candidates)
        clobber, probe_b = quirk_pre[1], quirk_pre[2]
        landing = torch.where(clobber[:, None, None], probe_b, merged)
    spawn_idx, spawn_val = source.spawn(landing)
    new_state, ts = step_with_spawn(
        config, state, action, spawn_idx, spawn_val,
        _precomputed=(merged, merge_score, valid, quirk_pre),
    )
    if config.auto_reset:
        new_state = _auto_reset(config, new_state, ts.done,
                                source.fresh(state.batch_size))
    return new_state, ts


def _quirk_probe(board, candidates):
    """Quirk-mode pre-move probe (nopenalty:68-78) from the pre-move board
    and its :func:`~tpu2048_torch.ops.board.move_all` results: its legal
    mask, the full-but-playable "clobber" flag, and the board and moved
    flag of the first legal move, which ``is_game_over`` leaves behind."""
    pre_legal = candidates[2].movedim(0, -1)
    game_over = ~pre_legal.any(-1)
    full = ~(board == 0).flatten(-2).any(-1)
    clobber = full & ~game_over
    first_legal = pre_legal.to(torch.int8).argmax(-1)  # the first max
    probe_b, _, probe_m = board_ops.select_move(*candidates, first_legal)
    return pre_legal, clobber, probe_b, probe_m


def step_with_spawn(config: EnvConfig, state: EnvState, action, spawn_idx,
                    spawn_val, _precomputed=None
                    ) -> Tuple[EnvState, TimeStep]:
    """Deterministic step: the spawn decisions are inputs.

    Used by :func:`step`, the trajectory-parity harness (which feeds the
    decisions it reads off the reference env) and the tests.
    ``spawn_idx`` indexes the row-major empty cells of whichever board the
    spawn lands on; ``spawn_val`` is the exponent (1 or 2). No auto-reset.
    """
    old_board = state.board
    action = torch.as_tensor(action, device=old_board.device).to(torch.int32)
    quirk_pre = None
    if _precomputed is None:
        candidates = board_ops.move_all(old_board)
        merged, merge_score, valid = board_ops.select_move(*candidates,
                                                           action)
        if config.reward == SIMPLE and config.quirk_compat:
            quirk_pre = _quirk_probe(old_board, candidates)
    else:
        merged, merge_score, valid, quirk_pre = _precomputed

    def keep(new, cond):
        return torch.where(cond[:, None, None], new, old_board)

    new_state = state
    if config.reward == SHAPED:
        # v1: the move commits and spawns at once (Game2048_env.py:51-63);
        # game over is read on the post-move board.
        new_board = keep(board_ops.spawn_at(merged, spawn_idx, spawn_val),
                         valid)
        legal_new = board_ops.legal_moves_mask(new_board)
        game_over = ~legal_new.any(-1)
        max_number = board_ops.max_tile_value(new_board)
        reward, new_prev_max = rw.shaped_reward(
            merge_score, valid, game_over, max_number, state.prev_max)
        # Stall bookkeeping (Game2048_env.py:110-127), after the base
        # reward, as in the reference.
        same = action == state.consec_action
        consec_count = torch.where(same, state.consec_count + 1, 1)
        last_penalty = torch.where(same, state.last_consec_penalty, -1.0)
        done = (~valid & game_over) | (consec_count > config.stall_force_done)
        stalled = consec_count > config.max_consecutive_actions
        penalty = torch.clamp_min(last_penalty * 1.1, -10.0)
        last_penalty = torch.where(stalled, penalty, last_penalty)
        reward = reward + torch.where(stalled, penalty, 0.0)
        new_state = dataclasses.replace(
            state, prev_max=new_prev_max, consec_action=action,
            consec_count=consec_count, last_consec_penalty=last_penalty)
    else:
        if config.quirk_compat:
            # Reference v2: game over on the PRE-move board; a full but
            # playable board returns the first legal probe move plus the
            # spawn (nopenalty:68-78, 109, 120).
            pre_legal, clobber, probe_b, probe_m = quirk_pre
            game_over = ~pre_legal.any(-1)
            visible = torch.where(clobber[:, None, None], probe_b, merged)
            spawned = board_ops.spawn_at(visible, spawn_idx, spawn_val)
            spawn_happens = torch.where(clobber, probe_m, valid)
            new_board = torch.where(spawn_happens[:, None, None], spawned,
                                    visible)
            # An invalid move without a clobber leaves the board as it was.
            new_board = keep(new_board, clobber | valid)
            legal_new = board_ops.legal_moves_mask(new_board)
        else:
            new_board = keep(
                board_ops.spawn_at(merged, spawn_idx, spawn_val), valid)
            legal_new = board_ops.legal_moves_mask(new_board)
            game_over = ~legal_new.any(-1)
        max_number = board_ops.max_tile_value(new_board)
        reward = rw.simple_reward(merge_score, valid, game_over)
        done = game_over
        if config.terminal_bonus:
            reward = reward + rw.terminal_bonus(
                rw.top2_tile_values(new_board), done)

    episode_return = state.episode_return + reward
    episode_steps = state.episode_steps + 1
    new_state = dataclasses.replace(
        new_state,
        board=new_board,
        score=state.score + merge_score,
        move_score=merge_score,
        episode_return=episode_return,
        episode_steps=episode_steps,
        done=done,
    )
    ts = TimeStep(
        obs=new_board,
        reward=reward,
        done=done,
        max_number=max_number,
        valid=valid,
        merge_score=merge_score,
        legal_mask=legal_new,
        episode_return=episode_return,
        episode_steps=episode_steps,
    )
    return new_state, ts


def _auto_reset(config: EnvConfig, state: EnvState, done: torch.Tensor,
                fresh: torch.Tensor) -> EnvState:
    """Finished lanes restart on ``fresh`` boards. Score and board reset;
    the shaping state (``prev_max``, the stall counters) persists across
    episodes (Game2048_env.py:187-191) unless
    ``reset_shaping_on_reset``."""

    def sel(new, old):
        return torch.where(done, new, old)

    state = dataclasses.replace(
        state,
        board=torch.where(done[:, None, None], fresh, state.board),
        score=sel(0, state.score),
        move_score=sel(0, state.move_score),
        episode_return=sel(0.0, state.episode_return),
        episode_steps=sel(0, state.episode_steps),
    )
    if config.reset_shaping_on_reset:
        state = dataclasses.replace(
            state,
            prev_max=sel(2, state.prev_max),
            consec_action=sel(-1, state.consec_action),
            consec_count=sel(0, state.consec_count),
            last_consec_penalty=sel(-1.0, state.last_consec_penalty),
        )
    return state


class Game2048Env:
    """Thin wrapper of an :class:`EnvConfig` with the env functions, in
    the reference's ``env.reset()``/``env.step(action)`` shape
    (Game2048_env.py:97, 187)."""

    def __init__(self, config: EnvConfig = EnvConfig()):
        self.config = config

    def reset(self, source, batch_size: int) -> EnvState:
        return reset(self.config, source, batch_size)

    def step(self, state: EnvState, action, source
             ) -> Tuple[EnvState, TimeStep]:
        return step(self.config, state, action, source)

    def step_with_spawn(self, state: EnvState, action, spawn_idx, spawn_val):
        return step_with_spawn(self.config, state, action, spawn_idx,
                               spawn_val)
