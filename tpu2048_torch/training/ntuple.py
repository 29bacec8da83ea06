"""The n-tuple lane trainer: B games in lockstep, each step one TD(0)
afterstate step of :mod:`tpu2048_torch.agents.ntuple` and one env step of
the fast env in simple mode (the step kernel through
:func:`tpu2048_torch.env.fast.fast_step`: merge-score reward, no terminal
bonus, a finished game reset in the same step). The policy is greedy: no
exploration, as in TDL2048.

A chunk is ``steps_per_chunk`` steps of :func:`train_step`; the running
counts stay on the device and the host reads them once a chunk. On the
card, with the production bit source (a :class:`~tpu2048_torch.env.fast.
GeneratorBits`), a chunk replays one step captured in a CUDA graph
(:mod:`tpu2048_torch.utils.cuda_graph`) instead of issuing its launches
from the host: the first chunk runs one step eagerly (the kernels' builds
and loads), captures, and replays the rest; :func:`eager_reason` says why
a chunk runs eagerly instead. The network's weights are updated in place, never
copied.

A step is the profiler span ``ntuple.step``, and in an eager step (or a
capture) its parts are ``ntuple.evaluate`` (the afterstate kernel),
``ntuple.learn`` (the TD-update kernel) and ``ntuple.env_step``; a replayed
step is one ``ntuple.step``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from tpu2048_torch.agents import ntuple as agent
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.models.ntuple import NTupleNetwork
from tpu2048_torch.ops import ntuple_kernel as nk
from tpu2048_torch.ops.step_kernel import fused_env_step
from tpu2048_torch.utils.cuda_graph import Graphs

# Simple mode: the merge score is the reward, and no terminal bonus.
ENV = fastlib.FastEnvConfig(terminal_bonus=False)


@dataclasses.dataclass(frozen=True)
class NTupleTrainConfig:
    agent: agent.NTupleConfig = agent.NTupleConfig()
    batch_size: int = 8192  # lanes
    steps_per_chunk: int = 128
    total_episodes: int = 100_000
    seed: int = 0


@dataclasses.dataclass
class NTupleTrainState:
    env_state: fastlib.FastEnvState
    lanes: agent.Lanes
    episodes_done: torch.Tensor  # () int64
    env_steps: torch.Tensor  # () int64
    sum_score: torch.Tensor  # () f64: final scores of finished games
    best_tile: torch.Tensor  # () int32
    # The last step's evaluation: V of each afterstate (-inf where
    # illegal), V of the previous afterstate, the actions taken.
    values: torch.Tensor  # (4, B) f32
    v_prev: torch.Tensor  # (B,) f32
    actions: torch.Tensor  # (B,) int32


def init_train_state(config: NTupleTrainConfig, bits) -> NTupleTrainState:
    """Fresh games from one draw of ``bits``, on its device."""
    b = config.batch_size
    env_state = fastlib.fast_reset(bits, b, ENV)
    device = env_state.boards.device

    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return NTupleTrainState(
        env_state=env_state, lanes=agent.init_lanes(b, device),
        episodes_done=zero((), torch.int64), env_steps=zero((), torch.int64),
        sum_score=zero((), torch.float64), best_tile=zero((), torch.int32),
        values=zero((4, b), torch.float32), v_prev=zero((b,), torch.float32),
        actions=zero((b,), torch.int32))


def train_step(config: NTupleTrainConfig, net: NTupleNetwork,
               state: NTupleTrainState, bits) -> NTupleTrainState:
    """One step of every lane; the network's weights are updated in place,
    every other tensor returned is new."""
    st = state
    with annotate("ntuple.step"):
        out = agent.evaluate(net, st.env_state.boards, st.lanes)
        agent.learn(net, st.lanes, out, config.agent.alpha)
        with annotate("ntuple.env_step"):
            env_state, ts = fastlib.fast_step(ENV, st.env_state, bits,
                                              out.action)
        final = st.env_state.score + ts.merge_score
        return NTupleTrainState(
            env_state=env_state,
            lanes=agent.Lanes(prev_after=out.chosen,
                              prev_valid=torch.ones_like(ts.done),
                              prev_terminal=ts.done),
            episodes_done=st.episodes_done + ts.done.sum(),
            env_steps=st.env_steps + config.batch_size,
            sum_score=st.sum_score + torch.where(ts.done, final, 0).sum(),
            best_tile=torch.maximum(st.best_tile, ts.max_number.amax()),
            values=out.values, v_prev=out.v_prev, actions=out.action)


def eager_reason(net: NTupleNetwork, bits) -> Optional[str]:
    """Why :func:`train_chunk` runs its steps eagerly, or None where it
    replays one captured step: ``"sources"`` (a bit source that is not
    exactly :class:`~tpu2048_torch.env.fast.GeneratorBits`: a graph replays
    the draws of a registered generator, never a Python call) or
    ``"device"`` (weights off the card)."""
    if type(bits) is not fastlib.GeneratorBits:
        return "sources"
    if not net.weights.is_cuda:
        return "device"
    return None


def train_chunk(config: NTupleTrainConfig, net: NTupleNetwork,
                state: NTupleTrainState, bits) -> NTupleTrainState:
    """Run ``steps_per_chunk`` steps. Where :func:`eager_reason` finds
    nothing they replay one captured :func:`train_step`
    (:mod:`tpu2048_torch.utils.cuda_graph`); the first chunk of a
    network, batch and source runs one step eagerly, captures, and replays
    the rest. The counts ``train_chunk.eager_steps``, ``.graph_steps`` and
    ``.captures`` say which ran."""
    return _GRAPHS.run(
        lambda st: train_step(config, net, st, bits), state,
        config.steps_per_chunk, eager_reason(net, bits),
        key=(config.agent, config.batch_size),  # what a step reads
        inplace=lambda: (net.weights,),
        generators=lambda: (bits.generator,))


# The kernels whose ``.launches`` count a step's launches.
_GRAPHS = Graphs(train_chunk, (nk.afterstate_values, nk.td_update_,
                               fused_env_step), "ntuple.step")


def train(config: NTupleTrainConfig, device,
          log_fn: Optional[Callable[[dict], None]] = None,
          save_path: Optional[str] = None) -> List[dict]:
    """Host loop: run chunks on ``device`` from zero weights until
    ``total_episodes`` games finish, the env's bits drawn from a generator
    seeded with ``seed``. Returns the per-chunk rows (also passed to
    ``log_fn``); with ``save_path`` the network is saved as an ``.npz``
    (:meth:`NTupleNetwork.save`)."""
    net = NTupleNetwork(config.agent.patterns, device)
    bits = fastlib.GeneratorBits(config.seed, device)
    state = init_train_state(config, bits)
    logs: List[dict] = []
    prev = dict(ep=0, score=0.0, t=time.time())
    while int(state.episodes_done) < config.total_episodes:
        state = train_chunk(config, net, state, bits)
        ep = int(state.episodes_done)  # waits for the chunk
        now = time.time()
        score = float(state.sum_score)
        row = {
            "episodes": ep,
            "env_steps": int(state.env_steps),
            "mean_score": (score - prev["score"]) / max(ep - prev["ep"], 1),
            "best_tile": int(state.best_tile),
            "steps_per_s": config.batch_size * config.steps_per_chunk
            / max(now - prev["t"], 1e-9),
        }
        prev = dict(ep=ep, score=score, t=now)
        logs.append(row)
        if log_fn:
            log_fn(row)
    if save_path:
        net.save(save_path)
    return logs
