"""Batched tabular Q-learning trainer, the port of
:mod:`tpu2048.training.tabular`.

B envs step in lockstep; each step is one epsilon-greedy choice, one env
step, the targets and the update of the table. The fast engine's env step
is one env-step kernel launch (shaped or simple mode); the lax engine's is
the classic env's plain ops (:mod:`tpu2048_torch.env.env`), which quirk
envs need. On the packed table (``table_backend`` ``auto`` or its alias
``pallas``) the choice is a bucket gather, the targets another, and the
update one scatter of the merged bucket images; on the legacy two-array
table (``legacy``) they are the ops of :mod:`tpu2048_torch.agents.tabular`.
Epsilon decays on the reference's per-episode schedule with "epoch" =
completed episodes / B.

A chunk is a Python loop of ``steps_per_chunk`` steps. On the packed table
it never waits for the device: the running sums stay on the device and the
host reads them once a chunk. The legacy update reads the number of its
ordered rounds once a step. With ``watchdog_timeout`` a watchdog exits the
process with code 70 when no chunk ends in that many seconds.

A step's four parts are profiler spans (:func:`tpu2048_torch.metrics.
profiling.annotate`, free with no profiler active): ``tabular.act`` (epsilon
and the choice), ``tabular.env_step``, ``tabular.learn`` (targets and the
table's update) and ``tabular.record`` (the running sums).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

import torch

from tpu2048_torch.agents import tabular as tab
from tpu2048_torch.agents import tabular_fast as tabf
from tpu2048_torch.env import env as envlib
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import SHAPED, EnvConfig
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.ops.step_kernel import from_cell_major
from tpu2048_torch.utils.watchdog import STARTUP_FLOOR, Watchdog


@dataclasses.dataclass(frozen=True)
class TabularTrainConfig:
    """``tpu2048.training.tabular.TabularTrainConfig`` without its fast
    engine's backend choice (the port runs the step kernel)."""

    agent: tab.TabularConfig = tab.TabularConfig()
    env: EnvConfig = EnvConfig(reward=SHAPED)
    batch_size: int = 1024
    total_episodes: int = 200_000  # the reference trained 200k games
    steps_per_chunk: int = 256
    # "fast": the env-step kernel; "lax": the classic env; "auto" picks.
    engine: str = "auto"
    # "auto" (or "pallas"): the packed table on the bucket kernels;
    # "legacy": the two-array table. JAX's "xla" and "interpret" name its
    # backends and have no counterpart on the card.
    table_backend: str = "auto"
    watchdog_timeout: float = 0.0  # exit 70 after this long without a chunk
    seed: int = 0


def resolve_table_backend(config: TabularTrainConfig) -> str:
    """``"packed"`` or ``"legacy"``; raises ValueError for any other name,
    JAX's ``"xla"`` and ``"interpret"`` included."""
    tb = config.table_backend
    if tb in ("auto", "pallas"):
        return "packed"
    if tb == "legacy":
        return "legacy"
    if tb in ("xla", "interpret"):
        raise ValueError(
            f"table_backend {tb!r} names a JAX backend; the port's plain "
            "versions run only for CPU tensors: use auto (or pallas) or "
            "legacy")
    raise ValueError(f"unknown table_backend {tb!r}")


def resolve_engine(config: TabularTrainConfig) -> str:
    """Pick the actor engine; an explicit "fast" on a quirk env raises."""
    return fastlib.resolve_engine(config.env, config.engine)


def fast_config(config: TabularTrainConfig) -> fastlib.FastEnvConfig:
    """The fast engine's config of the env (``for_env``)."""
    return fastlib.for_env(config.env)


@dataclasses.dataclass
class TabularTrainState:
    table: Union[tabf.PackedQTable, tab.QTable]
    env_state: Union[fastlib.FastEnvState, envlib.EnvState]
    episodes_done: torch.Tensor  # () int32
    env_steps: torch.Tensor  # () int32
    # Aggregates over finished episodes (running, never reset):
    sum_return: torch.Tensor  # () f32
    sum_score: torch.Tensor  # () f32
    sum_length: torch.Tensor  # () f32
    best_tile: torch.Tensor  # () int32
    action_counts: torch.Tensor  # (4,) int32


def init_train_state(config: TabularTrainConfig, bits) -> TabularTrainState:
    """Fresh envs and an empty table of the configured backend, on the
    device of ``bits``: the fast env's bit source, or on the lax engine the
    classic env's spawn source."""
    legacy = resolve_table_backend(config) == "legacy"
    if resolve_engine(config) == "lax":
        env_state = envlib.reset(config.env, bits, config.batch_size)
        device = env_state.board.device
    else:
        env_state = fastlib.fast_reset(bits, config.batch_size,
                                       fast_config(config))
        device = env_state.boards.device
    init = tab.qtable_init if legacy else tabf.packed_init

    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TabularTrainState(
        table=init(config.agent.capacity_log2, device),
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
    env (see :func:`init_train_state`), ``draws`` the agent. Returns the
    new state and the last step's epsilon (a float32 tensor). The table is
    updated in place."""
    agent_cfg = config.agent
    b = config.batch_size
    lax = resolve_engine(config) == "lax"
    fcfg = fast_config(config)
    legacy = resolve_table_backend(config) == "legacy"
    st = state
    eps = None
    for _ in range(config.steps_per_chunk):
        with annotate("tabular.act"):
            epoch = st.episodes_done.to(torch.float32) / b
            eps = tab.epsilon_for_epoch(epoch, agent_cfg)
            if lax:
                boards = st.env_state.board
            else:
                boards = from_cell_major(st.env_state.boards)
            if legacy:
                actions, probe = tab.choose_actions_probed(
                    st.table, boards, eps, draws)
            else:
                actions, probe = tabf.fast_choose_actions_probed(
                    st.table, boards, eps, draws)
        with annotate("tabular.env_step"):
            if lax:
                env_state, ts = envlib.step(config.env, st.env_state,
                                            actions, bits)
                next_boards = ts.obs
            else:
                env_state, ts = fastlib.fast_step(fcfg, st.env_state, bits,
                                                  actions, need_obs=True)
                next_boards = from_cell_major(ts.obs)
        with annotate("tabular.learn"):
            if legacy:
                targets = tab.q_learning_targets(
                    st.table, ts.reward, next_boards, ts.done,
                    agent_cfg.discount)
                table = tab.qtable_update(st.table, boards, actions, targets,
                                          agent_cfg.learning_rate,
                                          probe=probe)
            else:
                targets = tabf.fast_targets(st.table, ts.reward, next_boards,
                                            ts.done, agent_cfg.discount)
                table = tabf.fast_update(st.table, probe, actions, targets,
                                         agent_cfg.learning_rate)
        with annotate("tabular.record"):
            done_f = ts.done.to(torch.float32)
            st = TabularTrainState(
                table=table,
                env_state=env_state,
                episodes_done=st.episodes_done + ts.done.sum(
                    dtype=torch.int32),
                env_steps=st.env_steps + b,
                sum_return=st.sum_return + (ts.episode_return
                                            * done_f).sum(),
                sum_score=st.sum_score + torch.where(
                    ts.done, _episode_score(st, ts), 0.0).sum(),
                sum_length=st.sum_length + (ts.episode_steps
                                            * done_f).sum(),
                best_tile=torch.maximum(st.best_tile, ts.max_number.amax()),
                action_counts=st.action_counts + tab.one_hot(
                    actions, 4, torch.int32).sum(0, dtype=torch.int32),
            )
    return st, eps


def sources(seed: int, device, engine: str = "fast"):
    """The production source of the env (the fast env's bits, or the
    classic env's spawns for ``engine="lax"``) and draw source of the
    agent, two generators on ``device`` seeded from ``seed``."""
    env = envlib.GeneratorSpawns if engine == "lax" else fastlib.GeneratorBits
    return env(2 * seed, device), tabf.GeneratorDraws(2 * seed + 1, device)


def train(config: TabularTrainConfig, device,
          log_fn: Optional[Callable[[dict], None]] = None,
          save_path: Optional[str] = None) -> List[dict]:
    """Host loop: run chunks on ``device`` until ``total_episodes`` finish.

    Returns the per-chunk metric rows (also passed to ``log_fn``), with the
    JAX trainer's keys. With ``save_path`` the final table is written as a
    two-array ``.npz`` (:func:`tpu2048_torch.agents.tabular.save_qtable`).
    """
    bits, draws = sources(config.seed, device, resolve_engine(config))
    state = init_train_state(config, bits)
    watchdog = None
    if config.watchdog_timeout > 0:
        watchdog = Watchdog(config.watchdog_timeout, label="tabular",
                            startup_floor=STARTUP_FLOOR).start()
    try:
        return _train_loop(config, state, bits, draws, watchdog, log_fn,
                           save_path)
    finally:
        # A caller that catches an error and goes on must not be killed by
        # a watchdog left running.
        if watchdog is not None:
            watchdog.stop()


def _train_loop(config, state, bits, draws, watchdog, log_fn, save_path):
    logs: List[dict] = []
    prev = dict(ep=0, ret=0.0, score=0.0, length=0.0, t=time.time())
    while int(state.episodes_done) < config.total_episodes:
        state, eps = train_chunk(config, state, bits, draws)
        ep = int(state.episodes_done)  # waits for the chunk
        if watchdog is not None:
            watchdog.beat()
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
        table = state.table
        if isinstance(table, tabf.PackedQTable):
            table = tabf.unpack_qtable(table)
        tab.save_qtable(save_path, table)
    return logs
