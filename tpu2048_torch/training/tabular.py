"""Batched tabular Q-learning trainer, the port of
:mod:`tpu2048.training.tabular` on the fast engine and the packed table.

B envs step in lockstep; each step is one epsilon-greedy choice on a bucket
gather, one env-step kernel launch (shaped or simple mode), one gather for
the targets and one scatter of the merged updates into the table. Epsilon
decays on the reference's per-episode schedule with "epoch" = completed
episodes / B.

A chunk is a Python loop of ``steps_per_chunk`` steps that never waits for
the device: the running sums stay on the device and the host reads them
once a chunk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from tpu2048_torch.agents import tabular as tab
from tpu2048_torch.agents import tabular_fast as tabf
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import SHAPED, EnvConfig
from tpu2048_torch.ops.step_kernel import from_cell_major


@dataclasses.dataclass(frozen=True)
class TabularTrainConfig:
    """``tpu2048.training.tabular.TabularTrainConfig`` without its backend
    choices (the port has the fast engine and the packed table only) and
    the watchdog."""

    agent: tab.TabularConfig = tab.TabularConfig()
    env: EnvConfig = EnvConfig(reward=SHAPED)
    batch_size: int = 1024
    total_episodes: int = 200_000  # the reference trained 200k games
    steps_per_chunk: int = 256
    engine: str = "auto"  # "auto" or "fast"; the lax engine is not ported
    seed: int = 0


def fast_config(config: TabularTrainConfig) -> fastlib.FastEnvConfig:
    """The env's fast config; raises unless the fast engine can run it."""
    if fastlib.resolve_engine(config.env, config.engine) != "fast":
        raise NotImplementedError("engine='lax' is not yet ported")
    return fastlib.for_env(config.env)


@dataclasses.dataclass
class TabularTrainState:
    table: tabf.PackedQTable
    env_state: fastlib.FastEnvState
    episodes_done: torch.Tensor  # () int32
    env_steps: torch.Tensor  # () int32
    # Aggregates over finished episodes (running, never reset):
    sum_return: torch.Tensor  # () f32
    sum_score: torch.Tensor  # () f32
    sum_length: torch.Tensor  # () f32
    best_tile: torch.Tensor  # () int32
    action_counts: torch.Tensor  # (4,) int32


def init_train_state(config: TabularTrainConfig, bits) -> TabularTrainState:
    """Fresh envs from one draw of ``bits`` and an empty table, on the bit
    source's device."""
    env_state = fastlib.fast_reset(bits, config.batch_size,
                                   fast_config(config))
    device = env_state.boards.device

    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TabularTrainState(
        table=tabf.packed_init(config.agent.capacity_log2, device),
        env_state=env_state,
        episodes_done=zero((), torch.int32),
        env_steps=zero((), torch.int32),
        sum_return=zero((), torch.float32),
        sum_score=zero((), torch.float32),
        sum_length=zero((), torch.float32),
        best_tile=zero((), torch.int32),
        action_counts=zero((4,), torch.int32),
    )


def _episode_score(st: TabularTrainState, ts) -> torch.Tensor:
    """Episode merge score at termination: the pre-step episode score plus
    this step's (the state's score clears on auto-reset)."""
    return (st.env_state.score.to(torch.float32)
            + ts.merge_score.to(torch.float32))


def train_chunk(config: TabularTrainConfig, state: TabularTrainState, bits,
                draws):
    """Run ``steps_per_chunk`` env steps with learning; ``bits`` feeds the
    env, ``draws`` the agent. Returns the new state and the last step's
    epsilon (a float32 tensor). The table is updated in place."""
    agent_cfg = config.agent
    b = config.batch_size
    fcfg = fast_config(config)
    st = state
    eps = None
    for _ in range(config.steps_per_chunk):
        epoch = st.episodes_done.to(torch.float32) / b
        eps = tab.epsilon_for_epoch(epoch, agent_cfg)
        boards = from_cell_major(st.env_state.boards)
        actions, probe = tabf.fast_choose_actions_probed(
            st.table, boards, eps, draws)
        env_state, ts = fastlib.fast_step(fcfg, st.env_state, bits, actions,
                                          need_obs=True)
        targets = tabf.fast_targets(st.table, ts.reward,
                                    from_cell_major(ts.obs), ts.done,
                                    agent_cfg.discount)
        table = tabf.fast_update(st.table, probe, actions, targets,
                                 agent_cfg.learning_rate)
        done_f = ts.done.to(torch.float32)
        st = TabularTrainState(
            table=table,
            env_state=env_state,
            episodes_done=st.episodes_done + ts.done.sum(dtype=torch.int32),
            env_steps=st.env_steps + b,
            sum_return=st.sum_return + (ts.episode_return * done_f).sum(),
            sum_score=st.sum_score + torch.where(
                ts.done, _episode_score(st, ts), 0.0).sum(),
            sum_length=st.sum_length + (ts.episode_steps * done_f).sum(),
            best_tile=torch.maximum(st.best_tile, ts.max_number.amax()),
            action_counts=st.action_counts + tabf.one_hot(
                actions, 4, torch.int32).sum(0, dtype=torch.int32),
        )
    return st, eps


def sources(seed: int, device):
    """The production bit source of the env and draw source of the agent,
    two generators on ``device`` seeded from ``seed``."""
    return (fastlib.GeneratorBits(2 * seed, device),
            tabf.GeneratorDraws(2 * seed + 1, device))


def train(config: TabularTrainConfig, device,
          log_fn: Optional[Callable[[dict], None]] = None,
          save_path: Optional[str] = None) -> List[dict]:
    """Host loop: run chunks on ``device`` until ``total_episodes`` finish.

    Returns the per-chunk metric rows (also passed to ``log_fn``), with the
    JAX trainer's keys. With ``save_path`` the final table is written as a
    two-array ``.npz`` (:func:`tpu2048_torch.agents.tabular.save_qtable`).
    """
    bits, draws = sources(config.seed, device)
    state = init_train_state(config, bits)
    logs: List[dict] = []
    prev = dict(ep=0, ret=0.0, score=0.0, length=0.0, t=time.time())
    while int(state.episodes_done) < config.total_episodes:
        state, eps = train_chunk(config, state, bits, draws)
        ep = int(state.episodes_done)
        now = time.time()
        d_ep = max(ep - prev["ep"], 1)
        row = {
            "episodes": ep,
            "env_steps": int(state.env_steps),
            "epsilon": float(eps),
            "mean_return": (float(state.sum_return) - prev["ret"]) / d_ep,
            "mean_score": (float(state.sum_score) - prev["score"]) / d_ep,
            "mean_length": (float(state.sum_length) - prev["length"]) / d_ep,
            "best_tile": int(state.best_tile),
            "q_states": int(state.table.occupied.sum()),
            "dropped_updates": int(state.table.dropped),
            "action_counts": [int(x) for x in state.action_counts],
            "steps_per_s": config.batch_size * config.steps_per_chunk
            / max(now - prev["t"], 1e-9),
        }
        prev = dict(ep=ep, ret=float(state.sum_return),
                    score=float(state.sum_score),
                    length=float(state.sum_length), t=now)
        logs.append(row)
        if log_fn:
            log_fn(row)
    if save_path:
        tab.save_qtable(save_path, tabf.unpack_qtable(state.table))
    return logs
