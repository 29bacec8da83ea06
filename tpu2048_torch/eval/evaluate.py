"""Batched evaluation, the port of :mod:`tpu2048.eval.evaluate`.

Plays full games under a policy and collects the score, max-tile, length
and per-action distributions. On the fast engine the env auto-resets
finished boards, so each lane's FIRST completion is latched and its free
restarts are left out of the action counts; the random-legal policy runs
inside the rollout kernel, 16 steps a launch with the latches in registers.
The lax engine plays the classic env (:mod:`tpu2048_torch.env.env`) without
auto-reset, as plain ops: shaped and quirk envs run there. A policy's
step on the fast engine enters the profiler spans ``eval.policy`` and
``eval.env_step`` (:func:`tpu2048_torch.metrics.profiling.annotate`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from tpu2048_torch.agents import tabular_fast as tabf
from tpu2048_torch.agents.tabular import QTable
from tpu2048_torch.env import env as envlib
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops.step_kernel import from_cell_major

# Steps between host checks of "every game is over", as in the JAX harness:
# a batch plays whole chunks, so max_steps=64 plays 96 steps.
STEPS_PER_CALL = 32
# Steps a rollout launch plays in random-policy eval, as in the JAX harness.
RANDOM_STEPS_PER_CALL = 16


@dataclasses.dataclass
class Policy:
    """A policy: a function of ``(params, boards, legal_mask)`` returning
    ``(B,)`` int32 actions, and the weights it needs."""

    fn: Callable
    params: object = ()
    # True for the uniform-over-legal policy: the rollout kernel draws the
    # same distribution in-kernel, so eval runs it 16 steps a launch.
    in_kernel_random: bool = False

    def __call__(self, boards, legal_mask):
        return self.fn(self.params, boards, legal_mask)


def as_policy(policy) -> Policy:
    """Wrap a bare ``(boards, legal_mask)`` callable (no weights)."""
    if isinstance(policy, Policy):
        return policy
    return Policy(fn=lambda p, b, m: policy(b, m))


def _in_kernel_only(params, boards, legal_mask):
    raise TypeError("the random-legal policy without a generator is drawn "
                    "inside the rollout kernel from the eval's bit source: "
                    "play it through evaluate() on the fast engine, or give "
                    "it a generator")


def random_legal_actions(legal_mask: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """One uniform draw a lane picks among its legal moves, or among all
    four where none is legal (as JAX's categorical over equal logits
    does). Returns ``(B,)`` int32 actions."""
    legal = legal_mask | ~legal_mask.any(-1, keepdim=True)
    n = legal.sum(-1, dtype=torch.int32)
    u = torch.rand(legal.shape[0], generator=generator,
                   device=legal.device)
    pick = torch.minimum((u * n).to(torch.int32), n - 1)
    nth = (legal.cumsum(-1) == pick[:, None] + 1) & legal
    return nth.to(torch.int8).argmax(-1).to(torch.int32)


def _random_legal(generator, boards, legal_mask):
    return random_legal_actions(legal_mask, generator)


def random_legal_policy(generator: torch.Generator = None) -> Policy:
    """Uniform over the legal moves (GameDemo.py:272-285's random mode, with
    the JAX harness's delta: the reference also picks illegal moves).
    :func:`evaluate` on the fast engine plays it inside the rollout kernel
    on the eval's bit source; with a ``generator`` it also has a per-step
    form, drawn from that generator (the lax engine, the demo)."""
    fn = _in_kernel_only if generator is None else _random_legal
    return Policy(fn=fn, params=generator, in_kernel_random=True)


def _argmax_legal(q, legal_mask):
    """Argmax of Q over the legal moves; the plain argmax where no move is
    legal."""
    q_legal = torch.where(legal_mask, q, -torch.inf)
    return torch.where(
        legal_mask.any(-1), q_legal.argmax(-1), q.argmax(-1)
    ).to(torch.int32)


def _greedy(model, boards, legal_mask):
    with torch.inference_mode():
        q = model(boards)
    return _argmax_legal(q, legal_mask)


def greedy_dqn_policy(model: torch.nn.Module) -> Policy:
    """Argmax of Q over the legal moves (GameDemo.py:288-316); the module is
    put in eval mode (no dropout)."""
    return Policy(fn=_greedy, params=model.eval())


def _greedy_tabular(packed, boards, legal_mask):
    return _argmax_legal(tabf.fast_lookup(packed, boards), legal_mask)


def greedy_tabular_policy(table: QTable) -> Policy:
    """Argmax of the hashed Q-table over the legal moves
    (``tpu2048.eval.evaluate.greedy_tabular_policy``). The table is packed
    once, on its device, and read by the bucket gather each step."""
    return Policy(fn=_greedy_tabular, params=tabf.pack_qtable(table))


@dataclasses.dataclass
class EvalResult:
    scores: np.ndarray  # (N,) final episode merge scores
    max_tiles: np.ndarray  # (N,) final max tile values
    lengths: np.ndarray  # (N,) episode lengths
    # (4,) total L/U/R/D actions over live steps.
    action_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.int64)
    )
    batch_steps: int = 0  # batched env steps played: one kernel launch each
    env_steps: int = 0  # lane steps played, finished lanes included
    seconds: float = 0.0  # wall time of the games, results on the host

    @property
    def tile_distribution(self) -> Dict[int, int]:
        vals, counts = np.unique(self.max_tiles, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    def summary(self) -> dict:
        """The JAX harness's summary, plus the step counts and seconds."""
        total_actions = max(int(self.action_counts.sum()), 1)
        return {
            "games": int(len(self.scores)),
            "score_mean": float(self.scores.mean()),
            "score_std": float(self.scores.std()),
            "score_max": int(self.scores.max()),
            "length_mean": float(self.lengths.mean()),
            "max_tile_distribution": self.tile_distribution,
            "best_tile": int(self.max_tiles.max()),
            "win_rate_2048": float((self.max_tiles >= 2048).mean()),
            "action_counts": {
                k: int(c) for k, c in zip("LURD", self.action_counts)
            },
            "action_fractions": {
                k: round(float(c) / total_actions, 4)
                for k, c in zip("LURD", self.action_counts)
            },
            "batch_steps": self.batch_steps,
            "env_steps": self.env_steps,
            "seconds": self.seconds,
        }


def evaluate(
    policy,
    num_games: int,
    bits,
    env_config: EnvConfig = EnvConfig(reward="simple", auto_reset=False),
    batch_size: int = 512,
    max_steps: int = 4000,
    engine: str = "auto",
) -> EvalResult:
    """Play ``num_games`` full games under ``policy``; collect stats.

    ``engine``: "fast" plays the env kernels, "lax" the classic env (the
    only engine for quirk envs), "auto" picks (``resolve_engine``).
    ``bits`` is the engine's draw source, and the games run on its device:
    the fast env's bit source (:mod:`tpu2048_torch.env.fast`), or the
    classic env's spawn source (:mod:`tpu2048_torch.env.env`) for "lax".
    """
    engine = fastlib.resolve_engine(env_config, engine,
                                    require_auto_reset=False)
    policy = as_policy(policy)
    if engine == "lax":
        return _evaluate_lax(policy, num_games, bits, env_config, batch_size,
                             max_steps)
    return _evaluate_fast(policy, num_games, bits, env_config, batch_size,
                          max_steps)


def _evaluate_lax(policy: Policy, num_games, source, env_config, batch_size,
                  max_steps) -> EvalResult:
    """The classic env without auto-reset: a finished board stays finished,
    its first completion is latched (score, max tile, length) and its
    actions no longer count. The host reads "every game is over" once a
    chunk of ``STEPS_PER_CALL`` steps, as JAX's ``steps_per_call`` does."""
    env_config = dataclasses.replace(env_config, auto_reset=False)
    start = time.perf_counter()
    scores: List[np.ndarray] = []
    tiles: List[np.ndarray] = []
    lengths: List[np.ndarray] = []
    action_counts = np.zeros(4, np.int64)
    batch_steps = env_steps = 0
    remaining = num_games
    while remaining > 0:
        b = min(batch_size, remaining)
        state = envlib.reset(env_config, source, b)
        device = state.board.device
        actions_range = torch.arange(4, device=device)
        # Without auto-reset the step's legal mask of the new board is the
        # next step's: computed once here, then carried.
        legal = board_ops.legal_moves_mask(state.board)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        final_score = torch.zeros(b, dtype=torch.int32, device=device)
        final_tile = torch.zeros(b, dtype=torch.int32, device=device)
        final_len = torch.zeros(b, dtype=torch.int32, device=device)
        act_counts = torch.zeros(4, dtype=torch.int64, device=device)
        for _ in range(max_steps // STEPS_PER_CALL + 1):
            for _ in range(STEPS_PER_CALL):
                actions = policy(state.board, legal)
                live = ((actions.unsqueeze(-1) == actions_range)
                        & ~done[:, None])
                act_counts += live.sum(0)
                state, ts = envlib.step(env_config, state, actions, source)
                legal = ts.legal_mask
                newly = ts.done & ~done
                final_score = torch.where(newly, state.score, final_score)
                final_tile = torch.where(newly, ts.max_number, final_tile)
                final_len = torch.where(newly, ts.episode_steps, final_len)
                done = done | ts.done
            batch_steps += STEPS_PER_CALL
            env_steps += STEPS_PER_CALL * b
            if bool(done.all()):
                break
        # Any game still running at the end records its current standing.
        final_score = torch.where(done, final_score, state.score)
        final_tile = torch.where(done, final_tile,
                                 board_ops.max_tile_value(state.board))
        final_len = torch.where(done, final_len, state.episode_steps)
        scores.append(final_score.cpu().numpy())
        tiles.append(final_tile.cpu().numpy())
        lengths.append(final_len.cpu().numpy())
        action_counts += act_counts.cpu().numpy()
        remaining -= b

    return EvalResult(
        scores=np.concatenate(scores),
        max_tiles=np.concatenate(tiles),
        lengths=np.concatenate(lengths),
        action_counts=action_counts,
        batch_steps=batch_steps,
        env_steps=env_steps,
        seconds=time.perf_counter() - start,
    )


def _evaluate_fast(policy: Policy, num_games, bits, env_config, batch_size,
                   max_steps) -> EvalResult:
    """One kernel launch per step; the first completion of each lane is
    latched (score = pre-step episode score + the terminal move's merge
    score; tile and length from the terminal timestep)."""
    if policy.in_kernel_random:
        return _evaluate_fast_random(num_games, bits, env_config, batch_size,
                                     max_steps)
    fcfg = fastlib.for_env(env_config)
    start = time.perf_counter()
    scores: List[np.ndarray] = []
    tiles: List[np.ndarray] = []
    lengths: List[np.ndarray] = []
    action_counts = np.zeros(4, np.int64)
    batch_steps = env_steps = 0
    remaining = num_games
    while remaining > 0:
        b = min(batch_size, remaining)
        state = fastlib.fast_reset(bits, b, fcfg)
        device = state.boards.device
        actions_range = torch.arange(4, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        final_score = torch.zeros(b, dtype=torch.int32, device=device)
        final_tile = torch.zeros(b, dtype=torch.int32, device=device)
        final_len = torch.zeros(b, dtype=torch.int32, device=device)
        act_counts = torch.zeros(4, dtype=torch.int64, device=device)
        for _ in range(max_steps // STEPS_PER_CALL + 1):
            for _ in range(STEPS_PER_CALL):
                with annotate("eval.policy"):
                    actions = policy(from_cell_major(state.boards),
                                     state.legal)
                live = (actions.unsqueeze(-1) == actions_range) & ~done[:, None]
                act_counts += live.sum(0)
                with annotate("eval.env_step"):
                    new_state, ts = fastlib.fast_step(fcfg, state, bits,
                                                      actions,
                                                      need_legal=True)
                newly = ts.done & ~done
                final_score = torch.where(newly, state.score + ts.merge_score,
                                          final_score)
                final_tile = torch.where(newly, ts.max_number, final_tile)
                final_len = torch.where(newly, ts.episode_steps, final_len)
                done = done | ts.done
                state = new_state
            batch_steps += STEPS_PER_CALL
            env_steps += STEPS_PER_CALL * b
            if bool(done.all()):
                break
        # Any game still running at the end records its current standing.
        final_score = torch.where(done, final_score, state.score)
        final_tile = torch.where(
            done, final_tile,
            board_ops.max_tile_value(from_cell_major(state.boards)),
        )
        final_len = torch.where(done, final_len, state.episode_steps)
        scores.append(final_score.cpu().numpy())
        tiles.append(final_tile.cpu().numpy())
        lengths.append(final_len.cpu().numpy())
        action_counts += act_counts.cpu().numpy()
        remaining -= b

    return EvalResult(
        scores=np.concatenate(scores),
        max_tiles=np.concatenate(tiles),
        lengths=np.concatenate(lengths),
        action_counts=action_counts,
        batch_steps=batch_steps,
        env_steps=env_steps,
        seconds=time.perf_counter() - start,
    )


def _evaluate_fast_random(num_games, bits, env_config, batch_size,
                          max_steps) -> EvalResult:
    """Random-policy eval on the rollout kernel: 16 steps a launch, the
    first-completion latches in the kernel, and a host check after each
    launch that stops once every lane has latched. Lanes that never finished
    record their current standing, as in :func:`_evaluate_fast`."""
    fcfg = fastlib.for_env(env_config)
    k = RANDOM_STEPS_PER_CALL
    start = time.perf_counter()
    scores: List[np.ndarray] = []
    tiles: List[np.ndarray] = []
    lengths: List[np.ndarray] = []
    action_counts = np.zeros(4, np.int64)
    batch_steps = env_steps = 0
    remaining = num_games
    while remaining > 0:
        b = min(batch_size, remaining)
        state = fastlib.fast_reset(bits, b, fcfg)
        latch = fastlib.eval_latch_init(b, state.boards.device)
        for _ in range(max_steps // k + 1):
            state, latch = fastlib.fast_rollout_eval(fcfg, state, latch,
                                                     bits, k)
            batch_steps += k
            env_steps += k * b
            if bool(latch.latched.all()):
                break
        done = latch.latched != 0
        exp = latch.max_exp.to(torch.int32)
        final_tile = torch.where(
            done, torch.where(exp > 0, torch.ones_like(exp) << exp, 0),
            board_ops.max_tile_value(from_cell_major(state.boards)))
        scores.append(torch.where(done, latch.score, state.score).cpu()
                      .numpy())
        tiles.append(final_tile.cpu().numpy())
        lengths.append(torch.where(done, latch.steps, state.episode_steps)
                       .cpu().numpy())
        action_counts += latch.action_counts.sum(1).cpu().numpy()
        remaining -= b

    return EvalResult(
        scores=np.concatenate(scores),
        max_tiles=np.concatenate(tiles),
        lengths=np.concatenate(lengths),
        action_counts=action_counts,
        batch_steps=batch_steps,
        env_steps=env_steps,
        seconds=time.perf_counter() - start,
    )
