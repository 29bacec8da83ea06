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
episodes ended, the LR triggers and whether a replay shard is short of its
batch, in one transfer) and runs the updates as a Python loop: that read is
the only wait for the device inside a chunk. Everything else stays on the
device.

``replay_shards`` S splits the envs, the dedup lanes, the replay buffer and
the learner batch S ways (:mod:`tpu2048_torch.replay.sharded`); shard s has
its own env, actor and sampler generators, keyed by ``(seed, s)`` (shard 0
by the unsharded loop's keys, so that one shard is that loop bit for bit).
Over the ``(D, M)`` grid of a process group
(:mod:`tpu2048_torch.parallel.mesh`), a data row holds only its shards,
their lanes and the agent, draws only from its shards' generators and
averages each update's gradients over the data group before Adam; the
step's read becomes a sum over the data group, so every host decision is
taken alike everywhere, and a run of D data rows equals one process with
the same S. With ``model_parallel`` M > 1 each of a row's M ranks holds its
slices of the networks (:func:`tpu2048_torch.models.dqn.shard_module`) and
runs the row's lanes, as XLA runs arrays replicated over the ``model``
axis; the learner's dropout generator is keyed by the data index, so the
model ranks of a row draw the same masks.

Periodic operations keyed on episodes run between chunks, as in the JAX
loop: target sync every 20 episodes, the prune of the 10 worst buffered
episodes (of each shard, ``prune_n // S``) every 50, a full checkpoint
every 100, a named checkpoint at each new best tile >= 512, and the
optional rollback-on-regression. They read the running sums reduced over
the data group.

With ``trace_env0`` each vector step adds env 0's row of the reference's
per-step debug CSV (mainDQL:22-25, 234) to a list on the device; the host
reads the chunk's rows once, after the chunk, and hands each to
``trace_fn``. With ``watchdog_timeout`` a watchdog exits the process with
code 70 when no chunk (or checkpoint) ends in that many seconds.

A vector step's parts are profiler spans (:func:`tpu2048_torch.metrics.
profiling.annotate`, free with no profiler active): ``actor``,
``env_step``, ``replay_add`` and ``learner``; inside ``learner``, each
update's ``learner.sample`` and, where :func:`~tpu2048_torch.agents.dqn.
train_step` runs the update eagerly, its ``learner.forward``,
``learner.backward`` and ``learner.optimizer`` (a replayed update is one
graph launch).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tpu2048_torch.agents import dqn as dqnlib
from tpu2048_torch.env import env as envlib
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import SIMPLE, EnvConfig
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.models import dqn as dqn_model
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops.step_kernel import from_cell_major
from tpu2048_torch.parallel import mesh
from tpu2048_torch.replay import buffer as replaylib
from tpu2048_torch.replay import sharded
from tpu2048_torch.utils.watchdog import STARTUP_FLOOR, Watchdog

# Rollback-on-regression restores at most this many blocks in a row
# (mainDQL:292).
ROLLBACK_MAX_CONSECUTIVE = 2


@dataclasses.dataclass(frozen=True)
class DQNTrainConfig:
    """``tpu2048.training.dqn.DQNTrainConfig`` without its TPU knob
    (``fast_backend``)."""

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
    replay_shards: int = 1  # envs, replay and batch split S ways (ranks)
    # Ranks of a model group, each with its slices of the networks (JAX's
    # train(model_parallel=...)); the process group has D x M ranks.
    model_parallel: int = 1
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


MOMENTS = ("exp_avg", "exp_avg_sq")  # Adam's per-parameter state, sliced


def _map_moments(model: dqn_model.DQNCNN, optimizer: Dict, fn) -> Dict:
    """Adam's state dict ``optimizer`` with ``fn`` applied to the moments
    of each parameter ``model`` holds a slice of (in parameter order, as
    the collectives need); unsliced, ``optimizer`` as it is."""
    if not model.sliced:
        return optimizer
    names = [n for n, _ in model.named_parameters()]
    return dict(optimizer, state={i: {
        k: fn(v) if k in MOMENTS and names[i] in model.sliced else v
        for k, v in st.items()} for i, st in optimizer["state"].items()})


def _agent_dict(agent: dqnlib.DQNTrainState) -> Dict:
    """The whole agent: a sliced agent's networks and Adam's moments
    gathered over its model group (a collective of the group)."""
    model = agent.model
    return {
        "model": dqn_model.whole_state_dict(model),
        "target": dqn_model.whole_state_dict(agent.target),
        "optimizer": _map_moments(
            model, agent.optimizer.state_dict(),
            lambda v: mesh.gather_rows(v, model.model_group)),
        "step_counter": agent.step_counter,
        "train_steps": agent.train_steps,
        "generator": agent.generator.get_state(),
    }


def _load_agent(agent: dqnlib.DQNTrainState, state_payload: Dict) -> None:
    """The agent of a loop state's payload (whole; a sliced agent takes its
    slices); a rank's ``learner_generator`` (:meth:`DQNLoopState.rank_part`)
    wins over the agent's generator, and None keeps the generator as it
    is."""
    payload = state_payload["agent"]
    model = agent.model
    model.load_state_dict(dqn_model.slice_state_dict(model,
                                                     payload["model"]))
    agent.target.load_state_dict(dqn_model.slice_state_dict(
        agent.target, payload["target"]))
    optimizer = _map_moments(model, payload["optimizer"],
                             lambda v: mesh.slice_rows(v, model.model_group))
    # Optimizer.load_state_dict keeps tensors that are already on the
    # parameters' device and dtype: clone, so that a restored state never
    # shares memory with the payload (the rollback store keeps it).
    agent.optimizer.load_state_dict(_clone(optimizer))
    agent.step_counter = int(payload["step_counter"])
    agent.train_steps = int(payload["train_steps"])
    generator = state_payload.get("learner_generator", payload["generator"])
    if generator is not None:
        agent.generator.set_state(generator)


def _generators(source) -> List[torch.Generator]:
    """A draw source's generators: a sharded source's, one a shard."""
    gens = getattr(source, "generators", None)
    return gens if gens is not None else [source.generator]


def _generator_states(source) -> torch.Tensor:
    """The generators' states: one state, or one row a shard."""
    states = [g.get_state() for g in _generators(source)]
    return states[0] if len(states) == 1 else torch.stack(states)


def _set_generator_states(source, states: torch.Tensor) -> None:
    gens = _generators(source)
    rows = [states] if states.dim() == 1 else list(states)
    if len(rows) != len(gens):
        raise ValueError(f"{len(rows)} generator states for {len(gens)} "
                         "shards")
    for g, row in zip(gens, rows):
        # A generator takes a state of its own storage: a row of the
        # stacked states, a view, crashes the CPU generator.
        g.set_state(row.clone())


@dataclasses.dataclass
class DQNLoopState:
    """Everything the training loop carries across chunks: on a rank of a
    process group, its data row's lanes and replay shards and the agent (its
    slices of it when sliced; ``layout`` says which).

    ``bits`` feeds the env: the env kernel's bit source (``(8, B)`` rows a
    step) on the fast engine, the classic env's spawn source on the lax
    engine. ``draws`` feeds the actor and the sampler
    (:mod:`tpu2048_torch.agents.dqn`). With several shards on the rank each
    is a sharded source, one generator a shard. The counters that steer the
    host loop are host integers, the same on every rank; the running sums
    are device tensors over this rank's lanes (the loss sums, replicated).
    """

    env_state: Union[fastlib.FastEnvState, envlib.EnvState]
    dedup: dqnlib.DedupState
    buffer: replaylib.ReplayBuffer  # flat, or sharded (S, C/S + 1, ...)
    agent: dqnlib.DQNTrainState
    bits: Union[fastlib.GeneratorBits, fastlib.ShardedBits,
                envlib.GeneratorSpawns, envlib.ShardedSpawns]
    draws: Union[dqnlib.GeneratorDraws, dqnlib.ShardedDraws]
    layout: mesh.RankLayout
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
    # The sums over a data row's own lanes, then the replicated loss sums.
    LANE_SUMS = ("sum_return", "sum_score", "sum_length", "best_tile",
                 "sum_final_tile", "tile_hist")
    SUMS = (*LANE_SUMS, "loss_sum", "last_loss")
    # The payload's keys that are alike on every rank; the others, with the
    # learner's (dropout) generator, are a data row's own part.
    REPLICATED = ("agent", *COUNTERS, "loss_sum", "last_loss", "world",
                  "replay_shards")

    @property
    def device(self) -> torch.device:
        return self.sum_return.device

    @property
    def replay_shards(self) -> int:
        """The run's shards, over every data row."""
        return len(self.layout.shards) * self.layout.dp

    def _payload(self) -> Dict:
        """:meth:`state_dict` without the agent (the live tensors)."""
        shards = self.layout.shards
        return {
            "env_state": _tensors(self.env_state),
            "dedup": _tensors(self.dedup),
            "buffer": _tensors(self.buffer),
            "bits": _generator_states(self.bits),
            "draws": _generator_states(self.draws),
            "world": self.layout.dp,
            "replay_shards": self.replay_shards,
            "shards": [shards.start, shards.stop],
            **{k: getattr(self, k) for k in self.COUNTERS + self.SUMS},
        }

    def state_dict(self) -> Dict:
        """The whole state as nested dicts of tensors and numbers (the
        live tensors, not copies, but for a sliced agent's), with the
        data-parallel size (``world``), the shard count and the shards
        (``[start, stop)``) that wrote it. The agent is whole: a sliced
        agent is gathered over its model group, a collective of the
        group."""
        return {**self._payload(), "agent": _agent_dict(self.agent)}

    def rank_part(self) -> Dict:
        """This data row's own part of :meth:`state_dict`, no collective:
        its lanes, shards (named by ``shards``), generators and sums. A
        checkpoint holds data row 0's whole state and the other rows'
        parts; a rank's payload is assembled from them for its shards
        (:func:`shard_payload`, ``learner_generator`` replacing the
        agent's)."""
        part = {k: v for k, v in self._payload().items()
                if k not in self.REPLICATED}
        part["learner_generator"] = self.agent.generator.get_state()
        return part

    def check_layout(self, payload: Dict) -> None:
        """Raise unless ``payload`` has this run's shard count and this
        rank's lanes for its shards (a payload without a count: one
        shard). Any data- and model-parallel sizes resume it, as JAX's
        restore puts global arrays on any mesh; other global shapes raise,
        as there."""
        got = (payload.get("replay_shards", 1),
               payload["dedup"]["saved_count"].shape[0])
        if got != (self.replay_shards, self.layout.num_envs):
            raise ValueError(
                f"the checkpoint holds {got[0]} replay shard(s) and "
                f"{got[1]} env(s) in this rank's shards; this run has "
                f"{self.replay_shards} and {self.layout.num_envs}: "
                "resuming at another shard count or env count is not "
                "supported")

    def load_state_dict(self, payload: Dict) -> None:
        """Copy ``payload`` (:meth:`state_dict`'s, on any device, or one
        that :func:`shard_payload` assembled for this rank's shards) into
        this state; raise if its layout differs."""
        self.check_layout(payload)
        device = self.device
        self.env_state = _from_tensors(type(self.env_state),
                                       payload["env_state"], device)
        self.dedup = _from_tensors(dqnlib.DedupState, payload["dedup"],
                                   device)
        self.buffer = _from_tensors(replaylib.ReplayBuffer,
                                    payload["buffer"], device)
        _load_agent(self.agent, payload)
        _set_generator_states(self.bits, payload["bits"])
        _set_generator_states(self.draws, payload["draws"])
        for k in self.COUNTERS:
            setattr(self, k, int(payload[k]))
        for k in self.SUMS:
            setattr(self, k, payload[k].to(device, copy=True))


def _lane_axis(name: str) -> int:
    """The lane axis of a per-lane tensor of the env state or the dedup
    caches: 1 of the fast env's cell-major ``boards`` ``(16, B)``, else 0."""
    return 1 if name == "boards" else 0


def _shard_piece(part: Dict, held: range, s: int) -> Dict:
    """Shard ``s``'s lanes, replay shard and generator states, views of a
    part that holds the shards ``held`` (one shard: a flat buffer and one
    generator state; several: a leading shard axis)."""
    i, n = s - held.start, len(held)

    def lanes(tree):
        out = {}
        for k, v in tree.items():
            per = v.shape[_lane_axis(k)] // n
            out[k] = v.narrow(_lane_axis(k), i * per, per)
        return out

    buffer = part["buffer"]
    return {"env_state": lanes(part["env_state"]),
            "dedup": lanes(part["dedup"]),
            "buffer": buffer if n == 1 else {k: v[i]
                                             for k, v in buffer.items()},
            "bits": part["bits"] if n == 1 else part["bits"][i],
            "draws": part["draws"] if n == 1 else part["draws"][i]}


def _join_pieces(pieces: List[Dict]) -> Dict:
    """The shards' pieces side by side, as a part holding them has them."""
    if len(pieces) == 1:
        return dict(pieces[0])

    def lanes(key):
        return {k: torch.cat([p[key][k] for p in pieces], _lane_axis(k))
                for k in pieces[0][key]}

    return {"env_state": lanes("env_state"), "dedup": lanes("dedup"),
            "buffer": {k: torch.stack([p["buffer"][k] for p in pieces])
                       for k in pieces[0]["buffer"]},
            "bits": torch.stack([p["bits"] for p in pieces]),
            "draws": torch.stack([p["draws"] for p in pieces])}


def shard_payload(head: Dict, parts: List[Tuple[range, Dict]],
                  shards: range) -> Dict:
    """The payload of the data row that owns ``shards``, assembled from a
    checkpoint: ``head``, its replicated part (data row 0's
    :meth:`DQNLoopState.state_dict`), and every part with the shards it
    holds (``head`` among them). Each shard's lanes, replay shard and
    generators come from the part that holds it. The running sums and the
    dropout generator are a data row's own: a part that holds exactly
    ``shards`` gives them; else (a reshard) the row that owns shard 0 takes
    the totals over every part and the best tile's maximum, so that
    :func:`host_sums` reads the same totals, and the others start at zero
    and keep their own freshly keyed generator. Raises ValueError when a
    shard is in no part."""
    pieces = []
    for s in shards:
        holder = [(held, part) for held, part in parts if s in held]
        if not holder:
            raise ValueError(f"no part of the checkpoint holds replay shard "
                             f"{s}: it holds {head.get('replay_shards', 1)}")
        pieces.append(_shard_piece(holder[0][1], holder[0][0], s))
    payload = {k: head[k] for k in DQNLoopState.REPLICATED if k in head}
    payload.update(_join_pieces(pieces))
    payload["shards"] = [shards.start, shards.stop]
    own = [part for held, part in parts if held == shards]
    if own:
        payload.update({k: own[0][k] for k in DQNLoopState.LANE_SUMS})
        payload["learner_generator"] = own[0].get(
            "learner_generator", head["agent"]["generator"])
        return payload
    for k in DQNLoopState.LANE_SUMS:
        values = torch.stack([part[k] for _, part in parts])
        total = (values.amax(0) if k == "best_tile"
                 else values.sum(0, dtype=values.dtype))
        payload[k] = total if shards.start == 0 else torch.zeros_like(total)
    payload["learner_generator"] = (head["agent"]["generator"]
                                    if shards.start == 0 else None)
    return payload


def _seeds(seed: int, key: int):
    """``(agent, env, draws)`` seeds of shard (or data row) ``key``: shard 0
    keeps the unsharded loop's, shard s > 0 takes the child ``s`` of the
    run's seed sequence."""
    seq = (np.random.SeedSequence(seed) if key == 0
           else np.random.SeedSequence(seed, spawn_key=(key,)))
    return [int(x) for x in seq.generate_state(3)]


def _shard_source(single, sharded_cls, seeds, device):
    """One shard's source, or a sharded source over one a shard."""
    if len(seeds) == 1:
        return single(seeds[0], device)
    return sharded_cls([single(s, device) for s in seeds])


def init_loop_state(config: DQNTrainConfig, device) -> DQNLoopState:
    """Fresh envs, networks and an empty buffer on ``device``, for this
    process's rank (:func:`tpu2048_torch.parallel.mesh.rank_layout`; all
    shards without a process group). The networks are seeded from
    ``config.seed`` (rank 0's broadcast to the others, then sliced over the
    model group), each shard's env and draw generators from ``(seed,
    shard)``, the dropout generator of data row d > 0 from ``(seed, d)``."""
    layout = mesh.rank_layout(config.num_envs, config.train_batch,
                              config.replay_shards,
                              model_parallel=config.model_parallel)
    agent_seed = _seeds(config.seed, 0)[0]
    agent = dqnlib.create_train_state(config.agent, device, agent_seed,
                                      layout.model)
    device = next(agent.model.parameters()).device
    if layout.data_index:
        agent.generator.manual_seed(_seeds(config.seed,
                                           layout.data_index)[0])
    env_seeds = [_seeds(config.seed, s)[1] for s in layout.shards]
    draw_seeds = [_seeds(config.seed, s)[2] for s in layout.shards]
    b = layout.num_envs
    if resolve_engine(config) == "lax":
        bits = _shard_source(envlib.GeneratorSpawns, envlib.ShardedSpawns,
                             env_seeds, device)
        env_state = envlib.reset(config.env, bits, b)
    else:
        bits = _shard_source(fastlib.GeneratorBits, fastlib.ShardedBits,
                             env_seeds, device)
        env_state = fastlib.fast_reset(bits, b, fast_config(config))
    shards = len(layout.shards)

    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DQNLoopState(
        env_state=env_state,
        dedup=dqnlib.dedup_init(b, device),
        buffer=sharded.sharded_init(
            config.agent.memory_size // config.replay_shards * shards,
            shards, device),
        agent=agent,
        bits=bits,
        draws=_shard_source(dqnlib.GeneratorDraws, dqnlib.ShardedDraws,
                            draw_seeds, device),
        layout=layout,
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
    the learner's generator) and the replay buffer (this rank's shards,
    from the parts that hold them: any data- or model-parallel size).
    Fresh from ``state``: envs, dedup caches, the env's and the draws'
    generators, episode and env-step counters, update debt and every metric
    sum. ``named`` selects a named checkpoint, else ``step`` or the latest
    step; a missing source raises FileNotFoundError, one of another shard
    count ValueError.
    """
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager

    mgr = CheckpointManager(directory)
    if named is not None:
        if not mgr.has_named(named):
            raise FileNotFoundError(
                f"no named checkpoint {named!r} in {directory}")
        payload = mgr.read_named(named, state.layout.shards)
    else:
        s = step if step is not None else mgr.latest_step()
        if s is None:
            raise FileNotFoundError(f"no step checkpoints in {directory}")
        payload = mgr.read(s, state.layout.shards)
    state.check_layout(payload)
    _load_agent(state.agent, payload)
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
    """One vector step of this rank's lanes with its learner updates, in
    place; returns the step's epsilon. ``fcfg`` is the fast config, None on
    the lax engine. With a ``trace`` list, env 0's row is appended to it (on
    the device)."""
    acfg = config.agent
    b = st.layout.num_envs
    with annotate("actor"):
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
    with annotate("env_step"):
        if fcfg is None:
            env_state, ts = envlib.step(config.env, st.env_state, actions,
                                        st.bits)
            next_boards = ts.obs
        else:
            env_state, ts = fastlib.fast_step(fcfg, st.env_state, st.bits,
                                              actions, need_obs=True,
                                              need_legal=True)
            next_boards = from_cell_major(ts.obs)
    with annotate("replay_add"):
        save, st.dedup = dqnlib.dedup_mask(st.dedup, boards, next_boards,
                                           ts.done, acfg.dedup)
        sharded.sharded_add(st.buffer, boards, actions, ts.reward, ts.done,
                            next_boards, save)
    if trace is not None:
        trace.append(_trace_row(actions, legal, ts, save, boards))
    # The epsilon counter counts env steps, of every rank.
    st.agent.step_counter += config.num_envs
    # LR hook: x0.98 once per episode that ended with a >= 1024 pre-step
    # board (remember() checks np.max(state), Dqn8:284).
    triggers = ts.done & (board_ops.max_tile_value(boards)
                          >= acfg.lr_decay_tile)
    # The reference's replay() guard (Dqn8:353-354), per shard as in JAX:
    # skip (not defer) while a shard holds under its part of the batch.
    per_shard = config.train_batch // config.replay_shards
    short = (sharded.shard_sizes(st.buffer) < per_shard).sum()
    # The only wait for the device inside a chunk: this step's episode
    # ends, LR triggers and short shards, in one transfer, summed over the
    # data group (a model group's ranks hold the same lanes). The
    # learner's trip count and the LR are host values, alike on every rank.
    data_group = st.layout.data_group
    counts = mesh.all_reduce(torch.stack([
        ts.done.sum(), triggers.sum(), short]), data_group)
    n_done, n_trigger, n_short = counts.tolist()
    dqnlib.maybe_decay_lr(acfg, st.agent, n_trigger)

    can_train = n_short == 0 and eps < 1.0
    if config.updates_per_step is not None:
        n_upd = config.updates_per_step if can_train else 0
        debt_after = st.update_debt
    else:
        debt = st.update_debt + n_done * config.updates_per_episode
        n_upd = min(debt, config.max_updates_per_step) if can_train else 0
        debt_after = debt - n_upd if can_train else 0

    batch_size = st.layout.batch
    grad_reduce = (None if data_group is None else functools.partial(
        mesh.average_gradients, group=data_group))
    loss_sum = torch.zeros((), dtype=torch.float32, device=st.device)
    with annotate("learner"):
        for _ in range(n_upd):
            with annotate("learner.sample"):
                indices = st.draws.indices(st.buffer, batch_size, acfg.alpha)
                batch, indices, _ = sharded.sharded_sample(
                    st.buffer, batch_size, acfg.alpha, acfg.beta, indices)
            loss, td = dqnlib.train_step(acfg, st.agent, batch, grad_reduce)
            if acfg.alpha != 0.0:
                # |TD| -> priorities (Dqn8:389-390); at alpha=0 they are
                # never read.
                sharded.sharded_update_priorities(
                    st.buffer, indices, td, acfg.priority_epsilon)
            loss_sum = loss_sum + loss

    done_f = ts.done.to(torch.float32)
    final_exp = next_boards.reshape(b, 16).amax(-1).to(torch.int64)
    hist_inc = (board_ops.one_hot(final_exp.clamp(0, 16), 17, torch.int32)
                * ts.done[:, None]).sum(0, dtype=torch.int32)
    ep_score = (st.env_state.score + ts.merge_score).to(torch.float32)
    st.env_state = env_state
    st.episodes_done += n_done
    st.env_steps += config.num_envs
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


def host_sums(state: DQNLoopState) -> Dict:
    """The running values the host loop reads, over every data row:
    episodes (``ep``), the sums of returns, scores, lengths and final tiles,
    the buffer's size, the tile histogram (summed over the data group), the
    best tile (its maximum) and the loss sum and count (replicated)."""
    local = torch.cat([
        torch.stack([state.sum_return, state.sum_score, state.sum_length,
                     state.sum_final_tile]).to(torch.float64),
        sharded.total_size(state.buffer).to(torch.float64).reshape(1),
        state.tile_hist.to(torch.float64)])
    group = state.layout.data_group
    ret, score, length, tiles, size, *hist = mesh.all_reduce(
        local, group).tolist()
    best = mesh.all_reduce(state.best_tile.clone(), group, "max")
    return dict(ep=state.episodes_done, ret=ret, score=score, length=length,
                tiles=tiles, size=int(size), hist=[int(h) for h in hist],
                best=int(best), loss=float(state.loss_sum),
                nloss=state.loss_count)


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
                    state.buffer = sharded.sharded_prune(
                        state.buffer, max(1, config.prune_on_resume
                                          // config.replay_shards))
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
    prune_per_shard = max(1, config.prune_n // config.replay_shards)
    g = host_sums(state)
    prev = dict(g, t=time.time())
    last_sync = last_prune = last_ckpt = start_ep
    # Rollback bookkeeping (host-side, mainDQL:108-114).
    block = dict(idx=start_ep // max(config.rollback_block, 1), ep=start_ep,
                 tiles=g["tiles"], prev_avg=None, restored=0, rollbacks=0,
                 mem=None)
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
        g = host_sums(state)
        if ep // config.prune_episodes > last_prune // config.prune_episodes:
            if g["size"] > config.train_batch:
                state.buffer = sharded.sharded_prune(state.buffer,
                                                     prune_per_shard)
                g = host_sums(state)
            last_prune = ep
        best = g["best"]
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
            avg = (g["tiles"] - block["tiles"]) / max(ep - block["ep"], 1)
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
                g = host_sums(state)
                best = g["best"]
                prev.update(g)
            else:
                if use_mem:
                    block["mem"] = _clone(state.state_dict())
                else:
                    ckpt_manager.save_named("block_checkpoint", state)
                block["prev_avg"] = avg
                block["restored"] = 0
            block["ep"] = state.episodes_done
            block["tiles"] = g["tiles"]
            beat()  # the disk store's save or restore moves the state

        now = time.time()
        d_ep = max(ep - prev["ep"], 1)
        row = {
            "episodes": ep,
            "env_steps": state.env_steps,
            "epsilon": eps,
            "lr": dqnlib.current_lr(state.agent),
            "buffer_size": g["size"],
            "train_steps": state.agent.train_steps,
            "mean_return": (g["ret"] - prev["ret"]) / d_ep,
            "mean_score": (g["score"] - prev["score"]) / d_ep,
            "mean_length": (g["length"] - prev["length"]) / d_ep,
            "best_tile": best,
            "loss": (g["loss"] - prev["loss"])
            / max(g["nloss"] - prev["nloss"], 1),
            "tile_hist": g["hist"],
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
                    and not prev.get("debt_warned")
                    and mesh.is_primary_host()):
                prev["debt_warned"] = True
                print(
                    f"WARNING: learner debt {state.update_debt} updates and "
                    f"growing — max_updates_per_step="
                    f"{config.max_updates_per_step} cannot keep up with "
                    f"{config.num_envs} envs at updates_per_episode="
                    f"{config.updates_per_episode}; the reference update "
                    "ratio is not being met. Raise max_updates_per_step or "
                    "reduce --envs.", flush=True)
        prev.update(g, best=prev["best"], t=now)
        logs.append(row)
        if log_fn:
            log_fn(row)
        if config.stop_at_tile and best >= config.stop_at_tile:
            break
    if ckpt_manager is not None and state.episodes_done != last_ckpt:
        # Final save so short runs are resumable and evaluable.
        ckpt_manager.save(state.episodes_done, state)
    return logs
