"""Batched DQN actor-learner training driver, the port of
:mod:`tpu2048.training.dqn`.

B envs step in lockstep. Each vector step runs, in order: the legal mask and
the boards, epsilon-greedy :func:`select_actions` (one CNN forward), one env
step, the dedup rule and the replay insert, the epsilon counter, the x0.98
LR hook, and the learner. On the fast engine the env step is one env-step
kernel launch (``fast_step`` with the pre-reset board and the next legal
mask, which the next step's actor reads); on the lax engine it is the
classic env's plain ops (:mod:`tpu2048_torch.env.env`) and the actor
computes the legal mask from the boards. The learner keeps the
reference's update ratio with an update debt: each completed episode owes
``updates_per_episode`` (100) updates, drained up to
``max_updates_per_step`` a vector step, the rest carried; total updates =
100 x episodes once the ``can_train`` guard holds. ``updates_per_step``
sets a fixed count a step instead.

JAX runs the drain as a ``fori_loop`` whose trip count is computed on the
device. The port reads the step's counts on the host once a vector step (the
episodes ended, the LR triggers and the buffer's size, in one transfer) and
runs the updates as a Python loop: that read is the only wait for the
device inside a chunk. Everything else stays on the device.

Periodic operations keyed on episodes run between chunks, as in the JAX
loop: target sync every 20 episodes, the prune of the 10 worst buffered
episodes every 50, a full checkpoint every 100, a named checkpoint at each
new best tile >= 512, and the optional rollback-on-regression.

With ``trace_env0`` each vector step adds env 0's row of the reference's
per-step debug CSV (mainDQL:22-25, 234) to a list on the device; the host
reads the chunk's rows once, after the chunk, and hands each to
``trace_fn``. With ``watchdog_timeout`` a watchdog exits the process with
code 70 when no chunk (or checkpoint) ends in that many seconds.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from tpu2048_torch.agents import dqn as dqnlib
from tpu2048_torch.agents.tabular import one_hot
from tpu2048_torch.env import env as envlib
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import SIMPLE, EnvConfig
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops.step_kernel import from_cell_major
from tpu2048_torch.replay import buffer as replaylib
from tpu2048_torch.utils.watchdog import STARTUP_FLOOR, Watchdog

# Rollback-on-regression restores at most this many blocks in a row
# (mainDQL:292).
ROLLBACK_MAX_CONSECUTIVE = 2


@dataclasses.dataclass(frozen=True)
class DQNTrainConfig:
    """``tpu2048.training.dqn.DQNTrainConfig`` without its TPU and
    multi-device knobs (``fast_backend``, ``replay_shards``)."""

    agent: dqnlib.DQNConfig = dqnlib.DQNConfig()
    env: EnvConfig = EnvConfig(reward=SIMPLE, terminal_bonus=True)
    num_envs: int = 128
    # "fast": the env-step kernel; "lax": the classic env; "auto" picks.
    engine: str = "auto"
    # Learner schedule: None = the reference's update debt (mainDQL:223-
    # 226); an int = that many updates a vector step (ablations, benches).
    updates_per_step: Optional[int] = None
    updates_per_episode: int = 100  # mainDQL:225
    max_updates_per_step: int = 512  # debt drained per vector step, max
    train_batch: int = 64  # Dqn8:249 batch_size
    steps_per_chunk: int = 16  # vector steps between host-side operations
    target_sync_episodes: int = 20  # mainDQL:274
    prune_episodes: int = 50  # mainDQL:318
    prune_n: int = 10  # mainDQL:320
    checkpoint_episodes: int = 100  # mainDQL:324
    # Rollback-on-regression (mainDQL:278-314): every rollback_block
    # episodes compare the block's mean final max tile with the previous
    # block's, and restore the last block checkpoint on a drop.
    rollback: bool = False
    rollback_block: int = 20  # BLOCK_SIZE, mainDQL:109
    rollback_drop: float = 50.0
    rollback_store: str = "memory"  # a device-resident copy, or "disk"
    prune_on_resume: int = 0  # drop N worst episodes after a restore
    trace_env0: bool = False  # env 0's per-step debug rows (trace_fn)
    watchdog_timeout: float = 0.0  # exit 70 after this long without a chunk
    stop_at_tile: int = 0  # stop once best_tile reaches it (0 = off)
    seed: int = 0


def resolve_engine(config: DQNTrainConfig) -> str:
    """Pick the actor engine; an explicit "fast" on a quirk env raises."""
    return fastlib.resolve_engine(config.env, config.engine)


def fast_config(config: DQNTrainConfig) -> fastlib.FastEnvConfig:
    """The fast engine's config of the env (``for_env``)."""
    return fastlib.for_env(config.env)


def _tensors(obj) -> Dict[str, torch.Tensor]:
    """A dataclass of tensors as a dict (no copies)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _from_tensors(cls, payload: Dict, device):
    return cls(**{k: v.to(device, copy=True) for k, v in payload.items()})


def _clone(tree):
    """A deep copy of a state dict, tensors cloned on their device."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return copy.deepcopy(tree)


def _agent_dict(agent: dqnlib.DQNTrainState) -> Dict:
    return {
        "model": agent.model.state_dict(),
        "target": agent.target.state_dict(),
        "optimizer": agent.optimizer.state_dict(),
        "step_counter": agent.step_counter,
        "train_steps": agent.train_steps,
        "generator": agent.generator.get_state(),
    }


def _load_agent(agent: dqnlib.DQNTrainState, payload: Dict) -> None:
    agent.model.load_state_dict(payload["model"])
    agent.target.load_state_dict(payload["target"])
    # Optimizer.load_state_dict keeps tensors that are already on the
    # parameters' device and dtype: clone, so that a restored state never
    # shares memory with the payload (the rollback store keeps it).
    agent.optimizer.load_state_dict(_clone(payload["optimizer"]))
    agent.step_counter = int(payload["step_counter"])
    agent.train_steps = int(payload["train_steps"])
    agent.generator.set_state(payload["generator"])


@dataclasses.dataclass
class DQNLoopState:
    """Everything the training loop carries across chunks.

    ``bits`` feeds the env: the env kernel's bit source (``(8, B)`` rows a
    step) on the fast engine, the classic env's spawn source on the lax
    engine. ``draws`` feeds the actor and the sampler
    (:mod:`tpu2048_torch.agents.dqn`). The counters that steer the host
    loop are host integers, the running sums device tensors.
    """

    env_state: Union[fastlib.FastEnvState, envlib.EnvState]
    dedup: dqnlib.DedupState
    buffer: replaylib.ReplayBuffer
    agent: dqnlib.DQNTrainState
    bits: Union[fastlib.GeneratorBits, envlib.GeneratorSpawns]
    draws: dqnlib.GeneratorDraws
    episodes_done: int
    env_steps: int
    update_debt: int  # learner updates owed (debt mode)
    loss_count: int
    # Aggregates over finished episodes (running):
    sum_return: torch.Tensor  # () f32
    sum_score: torch.Tensor  # () f32
    sum_length: torch.Tensor  # () f32
    best_tile: torch.Tensor  # () int32
    sum_final_tile: torch.Tensor  # () f32, sum of episode-final max tiles
    tile_hist: torch.Tensor  # (17,) int32 final max-tile exponent histogram
    loss_sum: torch.Tensor  # () f32
    last_loss: torch.Tensor  # () f32

    COUNTERS = ("episodes_done", "env_steps", "update_debt", "loss_count")
    SUMS = ("sum_return", "sum_score", "sum_length", "best_tile",
            "sum_final_tile", "tile_hist", "loss_sum", "last_loss")

    @property
    def device(self) -> torch.device:
        return self.sum_return.device

    def state_dict(self) -> Dict:
        """The whole state as nested dicts of tensors and numbers (the
        live tensors, not copies)."""
        return {
            "env_state": _tensors(self.env_state),
            "dedup": _tensors(self.dedup),
            "buffer": _tensors(self.buffer),
            "agent": _agent_dict(self.agent),
            "bits": self.bits.generator.get_state(),
            "draws": self.draws.generator.get_state(),
            **{k: getattr(self, k) for k in self.COUNTERS + self.SUMS},
        }

    def load_state_dict(self, payload: Dict) -> None:
        """Copy ``payload`` (from :meth:`state_dict`, on any device) into
        this state."""
        device = self.device
        self.env_state = _from_tensors(type(self.env_state),
                                       payload["env_state"], device)
        self.dedup = _from_tensors(dqnlib.DedupState, payload["dedup"],
                                   device)
        self.buffer = _from_tensors(replaylib.ReplayBuffer,
                                    payload["buffer"], device)
        _load_agent(self.agent, payload["agent"])
        self.bits.generator.set_state(payload["bits"])
        self.draws.generator.set_state(payload["draws"])
        for k in self.COUNTERS:
            setattr(self, k, int(payload[k]))
        for k in self.SUMS:
            setattr(self, k, payload[k].to(device, copy=True))


def init_loop_state(config: DQNTrainConfig, device) -> DQNLoopState:
    """Fresh envs, networks and an empty buffer on ``device``; the
    networks', the env's and the draws' generators are seeded from
    ``config.seed``."""
    agent_seed, env_seed, draw_seed = (
        int(s) for s in np.random.SeedSequence(config.seed).generate_state(3))
    agent = dqnlib.create_train_state(config.agent, device, agent_seed)
    device = next(agent.model.parameters()).device
    if resolve_engine(config) == "lax":
        bits = envlib.GeneratorSpawns(env_seed, device)
        env_state = envlib.reset(config.env, bits, config.num_envs)
    else:
        bits = fastlib.GeneratorBits(env_seed, device)
        env_state = fastlib.fast_reset(bits, config.num_envs,
                                       fast_config(config))

    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DQNLoopState(
        env_state=env_state,
        dedup=dqnlib.dedup_init(config.num_envs, device),
        buffer=replaylib.replay_init(config.agent.memory_size, device),
        agent=agent,
        bits=bits,
        draws=dqnlib.GeneratorDraws(draw_seed, device),
        episodes_done=0,
        env_steps=0,
        update_debt=0,
        loss_count=0,
        sum_return=zero((), torch.float32),
        sum_score=zero((), torch.float32),
        sum_length=zero((), torch.float32),
        best_tile=zero((), torch.int32),
        sum_final_tile=zero((), torch.float32),
        tile_hist=zero((17,), torch.int32),
        loss_sum=zero((), torch.float32),
        last_loss=zero((), torch.float32),
    )


def warm_start_state(state: DQNLoopState, directory: str,
                     named: Optional[str] = None,
                     step: Optional[int] = None) -> DQNLoopState:
    """Graft another run's learned state onto a fresh loop state, in place:
    the reference's resumed-pretrained-lineage protocol (mainDQL:124-139).

    Carried from the source checkpoint: the agent (both networks, Adam's
    state with the decayed LR, the epsilon step counter, the update count,
    the learner's generator) and the replay buffer. Fresh from ``state``:
    envs, dedup caches, the env's and the draws' generators, episode and
    env-step counters, update debt and every metric sum. ``named`` selects
    a named checkpoint, else ``step`` or the latest step; a missing source
    raises FileNotFoundError.
    """
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager

    mgr = CheckpointManager(directory)
    if named is not None:
        if not mgr.has_named(named):
            raise FileNotFoundError(
                f"no named checkpoint {named!r} in {directory}")
        payload = mgr.read_named(named)
    else:
        s = step if step is not None else mgr.latest_step()
        if s is None:
            raise FileNotFoundError(f"no step checkpoints in {directory}")
        payload = mgr.read(s)
    _load_agent(state.agent, payload["agent"])
    state.buffer = _from_tensors(replaylib.ReplayBuffer, payload["buffer"],
                                 state.device)
    return state


def _trace_row(actions, legal, ts, save, boards) -> torch.Tensor:
    """Env 0's row of the debug trace as one float64 device tensor (every
    value exact): the action, the 4 legal flags, the reward, the episode's
    return, done, saved, the episode's steps and the 16 cells."""
    return torch.cat([x.to(torch.float64) for x in (
        actions[:1], legal[0], ts.reward[:1], ts.episode_return[:1],
        ts.done[:1], save[:1], ts.episode_steps[:1], boards[0].reshape(16))])


def _trace_rows(rows, episode: int, trace_fn) -> int:
    """Hand a chunk's trace rows to ``trace_fn`` in the JAX trainer's
    columns (episode, action, legal moves, reward, total reward, state,
    done, saved, step) after one read; returns env 0's episode count."""
    for r in torch.stack(rows).cpu().tolist():
        done = bool(r[7])
        trace_fn([episode, int(r[0]), [a for a in range(4) if r[1 + a]],
                  r[5], r[6], [int(c) for c in r[10:26]], done, bool(r[8]),
                  int(r[9])])
        episode += done
    return episode


def _vector_step(config: DQNTrainConfig, fcfg, st: DQNLoopState,
                 trace: Optional[list] = None) -> float:
    """One vector step with its learner updates, in place; returns the
    step's epsilon. ``fcfg`` is the fast config, None on the lax engine.
    With a ``trace`` list, env 0's row is appended to it (on the
    device)."""
    acfg = config.agent
    b = config.num_envs
    with record_function("actor"):
        if fcfg is None:
            boards = st.env_state.board
            legal = board_ops.legal_moves_mask(boards)
        else:
            boards = from_cell_major(st.env_state.boards)
            legal = st.env_state.legal  # kernel-emitted
        eps = dqnlib.epsilon_value(acfg, st.agent.step_counter)
        actions = dqnlib.select_actions(
            st.agent.model, boards, legal, ~st.dedup.last_saved,
            eps, st.draws.select(b))
    with record_function("env_step"):
        if fcfg is None:
            env_state, ts = envlib.step(config.env, st.env_state, actions,
                                        st.bits)
            next_boards = ts.obs
        else:
            env_state, ts = fastlib.fast_step(fcfg, st.env_state, st.bits,
                                              actions, need_obs=True,
                                              need_legal=True)
            next_boards = from_cell_major(ts.obs)
    with record_function("replay_add"):
        save, st.dedup = dqnlib.dedup_mask(st.dedup, boards, next_boards,
                                           ts.done, acfg.dedup)
        replaylib.replay_add(st.buffer, boards, actions, ts.reward, ts.done,
                             next_boards, save)
    if trace is not None:
        trace.append(_trace_row(actions, legal, ts, save, boards))
    st.agent.step_counter += b  # the epsilon counter counts env steps
    # LR hook: x0.98 once per episode that ended with a >= 1024 pre-step
    # board (remember() checks np.max(state), Dqn8:284).
    triggers = ts.done & (board_ops.max_tile_value(boards)
                          >= acfg.lr_decay_tile)
    # The only wait for the device inside a chunk: this step's episode
    # ends, LR triggers and buffer size, in one transfer. The learner's
    # trip count and the LR are host values.
    n_done, n_trigger, size = torch.stack([
        ts.done.sum(), triggers.sum(), st.buffer.size.to(torch.int64)
    ]).tolist()
    dqnlib.maybe_decay_lr(acfg, st.agent, n_trigger)

    # The reference's replay() guard: skip (not defer) while the buffer is
    # under one batch or epsilon has not started decaying (Dqn8:353-354).
    can_train = size >= config.train_batch and eps < 1.0
    if config.updates_per_step is not None:
        n_upd = config.updates_per_step if can_train else 0
        debt_after = st.update_debt
    else:
        debt = st.update_debt + n_done * config.updates_per_episode
        n_upd = min(debt, config.max_updates_per_step) if can_train else 0
        debt_after = debt - n_upd if can_train else 0

    loss_sum = torch.zeros((), dtype=torch.float32, device=st.device)
    with record_function("learner"):
        for _ in range(n_upd):
            indices = st.draws.indices(st.buffer, config.train_batch,
                                       acfg.alpha)
            batch, indices, _ = replaylib.replay_sample(
                st.buffer, config.train_batch, acfg.alpha, acfg.beta,
                indices=indices)
            loss, td = dqnlib.train_step(acfg, st.agent, batch)
            if acfg.alpha != 0.0:
                # |TD| -> priorities (Dqn8:389-390); at alpha=0 they are
                # never read.
                replaylib.replay_update_priorities(
                    st.buffer, indices, td, acfg.priority_epsilon)
            loss_sum = loss_sum + loss

    done_f = ts.done.to(torch.float32)
    final_exp = next_boards.reshape(b, 16).amax(-1).to(torch.int64)
    hist_inc = (one_hot(final_exp.clamp(0, 16), 17, torch.int32)
                * ts.done[:, None]).sum(0, dtype=torch.int32)
    ep_score = (st.env_state.score + ts.merge_score).to(torch.float32)
    st.env_state = env_state
    st.episodes_done += n_done
    st.env_steps += b
    st.update_debt = debt_after
    st.sum_return = st.sum_return + (ts.episode_return * done_f).sum()
    st.sum_score = st.sum_score + (ep_score * done_f).sum()
    st.sum_length = st.sum_length + (ts.episode_steps * done_f).sum()
    st.best_tile = torch.maximum(st.best_tile, ts.max_number.amax())
    st.sum_final_tile = st.sum_final_tile + (
        ts.max_number.to(torch.float32) * done_f).sum()
    st.tile_hist = st.tile_hist + hist_inc
    st.loss_sum = st.loss_sum + loss_sum
    st.loss_count += n_upd
    if n_upd > 0:
        st.last_loss = loss_sum / n_upd
    return eps


def train_chunk(config: DQNTrainConfig, state: DQNLoopState,
                trace: Optional[list] = None):
    """``steps_per_chunk`` vector steps with interleaved learning, in place.
    Returns the state and the last step's epsilon (a float32 value). With a
    ``trace`` list, each step appends env 0's debug row to it."""
    fcfg = fast_config(config) if resolve_engine(config) == "fast" else None
    eps = None
    for _ in range(config.steps_per_chunk):
        eps = _vector_step(config, fcfg, state, trace)
    return state, eps


def train(config: DQNTrainConfig, total_episodes: int, device=None,
          log_fn: Optional[Callable[[dict], None]] = None,
          state: Optional[DQNLoopState] = None, ckpt_manager=None,
          resume: bool = False,
          trace_fn: Optional[Callable[[list], None]] = None) -> List[dict]:
    """Host loop with the reference's periodic-op cadence; returns the
    per-chunk rows (the JAX loop's keys), also passed to ``log_fn``.

    ``state`` (default: a fresh one on ``device``) is trained in place.
    With ``ckpt_manager`` (a :class:`tpu2048_torch.checkpoint.ckpt.
    CheckpointManager`) the loop restores the latest step when ``resume``
    (the reference's resume path, mainDQL:124-139), saves every
    ``checkpoint_episodes``, saves a named checkpoint at each new best tile
    >= 512 (mainDQL:254-262), keeps the rollback's block checkpoint when
    ``rollback_store == "disk"``, and saves once more at the end. With
    ``config.trace_env0`` each of env 0's steps goes to ``trace_fn`` as a
    row of the reference's debug CSV.
    """
    watchdog = None
    if config.watchdog_timeout > 0:
        # Started before the restore: the start-up floor covers it.
        watchdog = Watchdog(config.watchdog_timeout, label="dqn",
                            startup_floor=STARTUP_FLOOR).start()
    try:
        if state is None:
            state = init_loop_state(config, device)
        if ckpt_manager is not None and resume:
            latest = ckpt_manager.latest_step()
            if latest is not None:
                ckpt_manager.restore(latest, state)
                if config.prune_on_resume > 0:
                    state.buffer = replaylib.prune_low_score_episodes(
                        state.buffer, config.prune_on_resume)
        return _train_loop(config, total_episodes, state, log_fn,
                           ckpt_manager, trace_fn, watchdog)
    finally:
        # A caller that catches an error and goes on must not be killed by
        # a watchdog left running.
        if watchdog is not None:
            watchdog.stop()


def _train_loop(config, total_episodes, state, log_fn, ckpt_manager,
                trace_fn, watchdog):
    beat = watchdog.beat if watchdog is not None else (lambda: None)
    tracing = config.trace_env0 and trace_fn is not None
    env0_episode = 0
    logs: List[dict] = []
    start_ep = state.episodes_done

    def sums():
        return dict(ep=state.episodes_done, ret=float(state.sum_return),
                    score=float(state.sum_score),
                    length=float(state.sum_length),
                    loss=float(state.loss_sum), nloss=state.loss_count)

    prev = dict(sums(), t=time.time(), best=int(state.best_tile))
    last_sync = last_prune = last_ckpt = start_ep
    # Rollback bookkeeping (host-side, mainDQL:108-114).
    block = dict(idx=start_ep // max(config.rollback_block, 1), ep=start_ep,
                 tiles=float(state.sum_final_tile), prev_avg=None,
                 restored=0, rollbacks=0, mem=None)
    use_mem = config.rollback_store == "memory"
    while state.episodes_done < total_episodes:
        trace = [] if tracing else None
        state, eps = train_chunk(config, state, trace)
        ep = state.episodes_done
        beat()
        if tracing:
            env0_episode = _trace_rows(trace, env0_episode, trace_fn)

        if ep // config.target_sync_episodes > (
                last_sync // config.target_sync_episodes):
            dqnlib.update_target(state.agent)
            last_sync = ep
        if ep // config.prune_episodes > last_prune // config.prune_episodes:
            if int(state.buffer.size) > config.train_batch:
                state.buffer = replaylib.prune_low_score_episodes(
                    state.buffer, config.prune_n)
            last_prune = ep
        best = int(state.best_tile)
        # Milestone saves at the reference's 512/1024/2048 tiers.
        if best >= 512 and best > prev["best"] and ckpt_manager is not None:
            ckpt_manager.save_named(f"tile_{best}_ep{ep}", state)
            beat()  # a save of the whole state is slow I/O, not a hang
        prev["best"] = max(prev["best"], best)
        if ep // config.checkpoint_episodes > (
                last_ckpt // config.checkpoint_episodes):
            if ckpt_manager is not None:
                ckpt_manager.save(ep, state)
                beat()
            last_ckpt = ep

        # Rollback-on-regression (mainDQL:278-314).
        if (config.rollback and (use_mem or ckpt_manager is not None)
                and ep // config.rollback_block > block["idx"]):
            block["idx"] = ep // config.rollback_block
            avg = (float(state.sum_final_tile) - block["tiles"]) / max(
                ep - block["ep"], 1)
            has_backup = (block["mem"] is not None if use_mem
                          else ckpt_manager.has_named("block_checkpoint"))
            if (block["prev_avg"] is not None
                    and block["prev_avg"] - avg > config.rollback_drop
                    and block["restored"] < ROLLBACK_MAX_CONSECUTIVE
                    and has_backup):
                if use_mem:
                    # Load a copy: the backup must survive for the next
                    # (possibly consecutive) restore.
                    state.load_state_dict(block["mem"])
                else:
                    ckpt_manager.restore_named("block_checkpoint", state)
                block["restored"] += 1
                block["rollbacks"] += 1
                ep = state.episodes_done
                # Rewind the block index and the periodic-op bookkeeping
                # to the restored episode, keep prev_avg (mainDQL:299), and
                # rewind the rows' baselines and best tile.
                block["idx"] = ep // config.rollback_block
                last_sync = min(last_sync, ep)
                last_prune = min(last_prune, ep)
                last_ckpt = min(last_ckpt, ep)
                best = int(state.best_tile)
                prev.update(sums(), best=best)
            else:
                if use_mem:
                    block["mem"] = _clone(state.state_dict())
                else:
                    ckpt_manager.save_named("block_checkpoint", state)
                block["prev_avg"] = avg
                block["restored"] = 0
            block["ep"] = state.episodes_done
            block["tiles"] = float(state.sum_final_tile)
            beat()  # the disk store's save or restore moves the state

        now = time.time()
        d_ep = max(ep - prev["ep"], 1)
        cur = sums()
        row = {
            "episodes": ep,
            "env_steps": state.env_steps,
            "epsilon": eps,
            "lr": dqnlib.current_lr(state.agent),
            "buffer_size": int(state.buffer.size),
            "train_steps": state.agent.train_steps,
            "mean_return": (cur["ret"] - prev["ret"]) / d_ep,
            "mean_score": (cur["score"] - prev["score"]) / d_ep,
            "mean_length": (cur["length"] - prev["length"]) / d_ep,
            "best_tile": best,
            "loss": (cur["loss"] - prev["loss"])
            / max(cur["nloss"] - prev["nloss"], 1),
            "tile_hist": [int(x) for x in state.tile_hist],
            "steps_per_s": config.num_envs * config.steps_per_chunk
            / max(now - prev["t"], 1e-9),
        }
        if config.rollback:
            row["rollbacks"] = block["rollbacks"]
        if config.updates_per_step is None:
            # The learner backlog: a debt that grows without bound means
            # max_updates_per_step is too small for this env count.
            row["update_debt"] = state.update_debt
            if (state.update_debt > 20 * config.max_updates_per_step
                    and not prev.get("debt_warned")):
                prev["debt_warned"] = True
                print(
                    f"WARNING: learner debt {state.update_debt} updates and "
                    f"growing — max_updates_per_step="
                    f"{config.max_updates_per_step} cannot keep up with "
                    f"{config.num_envs} envs at updates_per_episode="
                    f"{config.updates_per_episode}; the reference update "
                    "ratio is not being met. Raise max_updates_per_step or "
                    "reduce --envs.", flush=True)
        prev.update(cur, t=now)
        logs.append(row)
        if log_fn:
            log_fn(row)
        if config.stop_at_tile and best >= config.stop_at_tile:
            break
    if ckpt_manager is not None and state.episodes_done != last_ckpt:
        # Final save so short runs are resumable and evaluable.
        ckpt_manager.save(state.episodes_done, state)
    return logs
