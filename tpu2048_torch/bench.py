"""Throughput benchmarks of the port on one card, each printing one JSON line
(the counterpart of the repository root's ``bench.py``, which measures the
JAX package).

``main`` times the random-policy env: ``steps`` env steps of ``batch``
lanes as ``steps / rollout_k`` launches of
:func:`tpu2048_torch.env.fast.fast_rollout`, with the bits drawn by Philox
inside the kernel; with ``rollout_k`` 1 the single-step path instead, one
:func:`tpu2048_torch.env.fast.fast_step` (one step-kernel launch, the
kernel's random-legal policy) a step on bits from
:class:`~tpu2048_torch.env.fast.GeneratorBits`. ``tabular_main`` times the
tabular training chunk (shaped fast env and the step kernel, on the packed
hashed Q-table and its gather and scatter kernels, or with
``table_backend="legacy"`` the two-array table in plain ops).
``learner_main`` times the DQN learner's updates at full width, and
``train_loop_main`` the DQN training chunk's actor side (CNN policy, step
kernel, dedup, replay insert) with no updates. ``scale_main`` times the
whole DQN training chunk data parallel over 1, 2, ... ranks (one line a
rank count).

Each warms up with the same work it then times, and fences the timed run by
synchronizing the device and reading a result on the host. Each line names
the card and its power limit (``nvidia-smi``), or ``"cpu"``. Run them as
``python -m tpu2048_torch bench [--rollout-k K | --tabular [--table-backend
B] | --learner | --train-loop | --scale 1,2,...] [--cpu]``. The env bench's
defaults are 65536 lanes and 256 steps, where the JAX bench's are 131072
and 2048.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Optional

import torch

from tpu2048_torch.env.fast import (FastEnvConfig, GeneratorBits,
                                    PhiloxBits, fast_reset, fast_rollout,
                                    fast_step)
from tpu2048_torch.ops import step_kernel as sk
from tpu2048_torch.utils.device import resolve_device

# The JAX bench's env: simple reward with the terminal bonus.
ROLLOUT_ENV = FastEnvConfig(terminal_bonus=True)
# The JAX bench's tabular shape: table capacity 2**24, 256 steps a chunk,
# one warm chunk and then the timed ones.
TABULAR_CAPACITY_LOG2 = 24
TABULAR_STEPS_PER_CHUNK = 256
TABULAR_TIMED_CHUNKS = 4
# The JAX train-loop bench's chunk: 64 steps, no updates.
TRAIN_LOOP_STEPS_PER_CHUNK = 64
# The JAX scaling bench's chunk: 32 steps with one update each.
SCALE_STEPS_PER_CHUNK = 32
# Its efficiency target, BASELINE.md's 85% of linear.
SCALE_TARGET = 0.85


def card_name(device: torch.device) -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(batch: int = 65536, steps: int = 256, rollout_k: int = 16,
         device: Optional[str] = None) -> dict:
    """Random-policy env-steps/s; returns the printed row. ``launches``
    counts the kernel launches of the timed run (0 on the CPU, where the
    plain version runs): the rollout kernel's, or with ``rollout_k`` 1 the
    step kernel's, whose row also gives the timed run's summed ``reward``."""
    device = resolve_device(device)
    if steps % rollout_k:
        raise ValueError(f"steps {steps} not divisible by k {rollout_k}")
    windows = steps // rollout_k
    config = ROLLOUT_ENV
    if rollout_k == 1:
        # PhiloxBits would draw each step's rows on the host in eager ops.
        bits, kernel = GeneratorBits(0, device), sk.fused_env_step

        def window(state):
            state, ts = fast_step(config, state, bits)
            return state, ts.reward, ts.done
    else:
        bits, kernel = PhiloxBits(0, device), sk.fused_env_rollout

        def window(state):
            return fast_rollout(config, state, bits, rollout_k)
    state = fast_reset(bits, batch, config)

    def run(state):
        reward = torch.zeros((), dtype=torch.float32, device=device)
        dones = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(windows):
            state, reward_sum, done_count = window(state)
            reward += reward_sum.sum(dtype=torch.float32)
            dones += done_count.sum()
        return state, reward, dones

    state, reward, _ = run(state)
    float(reward)
    _sync(device)
    before = kernel.launches
    t0 = time.perf_counter()
    state, reward, dones = run(state)
    float(reward)
    _sync(device)
    seconds = time.perf_counter() - t0
    row = {
        "bench": "rollout",
        "env_steps_per_s": batch * steps / seconds,
        "batch": batch,
        "steps": steps,
        "rollout_k": rollout_k,
        "windows": windows,
        "launches": kernel.launches - before,
        "bits": "philox",
        "episodes": int(dones),
        "seconds": seconds,
        "card": card_name(device),
    }
    if rollout_k == 1:
        row.update(bits="generator", reward=float(reward))
    print(json.dumps(row))
    return row


def tabular_main(batch: int = 4096, device: Optional[str] = None,
                 table_backend: str = "auto") -> dict:
    """Tabular training env-steps/s and ms a step at the JAX bench's shape:
    one warm chunk, then ``TABULAR_TIMED_CHUNKS`` timed ones, on the table
    of ``table_backend`` (``auto``/``pallas`` packed, ``legacy``; any other
    name raises ValueError); returns the printed row."""
    from tpu2048_torch.agents.tabular import TabularConfig
    from tpu2048_torch.training import tabular as ttrain

    device = resolve_device(device)
    capacity_log2, chunks = TABULAR_CAPACITY_LOG2, TABULAR_TIMED_CHUNKS
    steps_per_chunk = TABULAR_STEPS_PER_CHUNK
    config = ttrain.TabularTrainConfig(
        agent=TabularConfig(capacity_log2=capacity_log2, total_epochs=100),
        batch_size=batch,
        steps_per_chunk=steps_per_chunk,
        table_backend=table_backend,
    )
    backend = ttrain.resolve_table_backend(config)
    bits, draws = ttrain.sources(0, device)
    state = ttrain.init_train_state(config, bits)
    state, _ = ttrain.train_chunk(config, state, bits, draws)
    int(state.env_steps)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(chunks):
        state, _ = ttrain.train_chunk(config, state, bits, draws)
    int(state.env_steps)
    _sync(device)
    seconds = time.perf_counter() - t0
    n_steps = steps_per_chunk * chunks
    row = {
        "bench": "tabular",
        "env_steps_per_s": batch * n_steps / seconds,
        "ms_per_step": 1e3 * seconds / n_steps,
        "batch": batch,
        "capacity_log2": capacity_log2,
        "table_backend": backend,
        "steps_per_chunk": steps_per_chunk,
        "chunks": chunks,
        "seconds": seconds,
        "card": card_name(device),
    }
    print(json.dumps(row))
    return row


def learner_update(acfg, batch: int, device: torch.device):
    """The learner that :func:`learner_main` times: a train state of
    ``acfg``'s network (seed 0) and a 4096-slot buffer holding 1,024
    random transitions. Returns ``(state, update)``; each ``update()`` draws
    a batch of ``batch`` and runs one
    :func:`tpu2048_torch.agents.dqn.train_step`, returning the loss (a
    device tensor)."""
    from tpu2048_torch.agents import dqn as dqnlib
    from tpu2048_torch.replay import buffer as replaylib
    from tpu2048_torch.replay import sharded

    state = dqnlib.create_train_state(acfg, device, 0)
    gen = torch.Generator(device=device).manual_seed(1)
    n_fill = 1024

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    buf = sharded.sharded_init(acfg.memory_size, 1, device)
    sharded.sharded_add(
        buf, randint(12, (n_fill, 4, 4)), randint(4, (n_fill,)),
        torch.rand(n_fill, generator=gen, device=device),
        torch.zeros(n_fill, dtype=torch.bool, device=device),
        randint(12, (n_fill, 4, 4)),
        torch.ones(n_fill, dtype=torch.bool, device=device))

    def update():
        sample, _, _ = sharded.sharded_sample(
            buf, batch, acfg.alpha, acfg.beta,
            replaylib.sample_indices(buf, batch, acfg.alpha, gen))
        return dqnlib.train_step(acfg, state, sample)[0]

    return state, update


def learner_main(batch: int = 64, updates: int = 200,
                 device: Optional[str] = None, agent=None) -> dict:
    """DQN learner updates/s: ``updates`` warm updates, then ``updates``
    timed ones, each a sample from a 4096-slot buffer holding 1,024 random
    transitions and one :func:`tpu2048_torch.agents.dqn.train_step` (target
    forward, train forward and backward, Adam) of the network of ``agent``
    (default: the reference's, full width, bf16). Returns the printed
    row."""
    from tpu2048_torch.agents import dqn as dqnlib

    device = resolve_device(device)
    acfg = agent or dqnlib.DQNConfig(memory_size=4096)
    _, update = learner_update(acfg, batch, device)

    def run():
        loss = None
        for _ in range(updates):
            loss = update()
        return float(loss)

    run()
    _sync(device)
    t0 = time.perf_counter()
    loss = run()
    _sync(device)
    seconds = time.perf_counter() - t0
    row = {
        "metric": "dqn_updates_per_s_per_chip",
        "value": updates / seconds,
        "unit": "updates/s",
        "ms_per_update": 1e3 * seconds / updates,
        "batch": batch,
        "updates": updates,
        "features": acfg.features,
        "hidden": acfg.hidden,
        "blocks": acfg.num_blocks,
        "bf16": acfg.bf16,
        "loss": loss,
        "seconds": seconds,
        "card": card_name(device),
    }
    print(json.dumps(row))
    return row


def train_loop_main(envs: int = 128, chunks: int = 8,
                    device: Optional[str] = None, agent=None) -> dict:
    """Actor-side env-steps/s of the DQN training chunk: the kernel's legal
    mask, the epsilon-greedy CNN forward (``agent``'s network, default the
    reference's at full width), the step kernel, dedup and the replay
    insert, with no learner updates (``updates_per_step=0``);
    ``TRAIN_LOOP_STEPS_PER_CHUNK`` steps a chunk, one warm chunk, then
    ``chunks`` timed. Returns the printed row."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.training import dqn as dtrain

    device = resolve_device(device)
    config = dtrain.DQNTrainConfig(agent=agent or DQNConfig(),
                                   num_envs=envs, updates_per_step=0,
                                   steps_per_chunk=TRAIN_LOOP_STEPS_PER_CHUNK)
    state = dtrain.init_loop_state(config, device)
    dtrain.train_chunk(config, state)
    _sync(device)
    before = sk.fused_env_step.launches
    t0 = time.perf_counter()
    for _ in range(chunks):
        dtrain.train_chunk(config, state)
    int(state.buffer.size)
    _sync(device)
    seconds = time.perf_counter() - t0
    n_steps = config.steps_per_chunk * chunks
    row = {
        "metric": "train_loop_env_steps_per_s_per_chip",
        "value": envs * n_steps / seconds,
        "unit": "env-steps/s",
        "ms_per_step": 1e3 * seconds / n_steps,
        "envs": envs,
        "steps_per_chunk": config.steps_per_chunk,
        "chunks": chunks,
        "launches": sk.fused_env_step.launches - before,
        "features": config.agent.features,
        "bf16": config.agent.bf16,
        "seconds": seconds,
        "card": card_name(device),
    }
    print(json.dumps(row))
    return row


def scale_config(n: int, envs_per_rank: int = 256,
                 steps_per_chunk: int = SCALE_STEPS_PER_CHUNK):
    """The scaling bench's train config over ``n`` ranks (JAX's
    ``scale_main``): a tiny float32 CNN (features 32, hidden 32, 1 block),
    ``envs_per_rank`` envs, 32 samples, 4,096 replay slots and one replay
    shard a rank, one update a vector step, 32 steps a chunk."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.training import dqn as dtrain

    return dtrain.DQNTrainConfig(
        agent=DQNConfig(features=32, hidden=32, num_blocks=1, bf16=False,
                        dropout=0.0, memory_size=4096 * n),
        num_envs=envs_per_rank * n, updates_per_step=1, train_batch=32 * n,
        steps_per_chunk=steps_per_chunk, replay_shards=n)


def _scale_rank(n: int, envs_per_rank: int, chunks: int,
                steps_per_chunk: int) -> dict:
    """One rank of :func:`scale_main`: a warm chunk, then ``chunks`` timed,
    all ranks starting and ending at barriers."""
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.training import dqn as dtrain

    device = mesh.local_device()
    config = scale_config(n, envs_per_rank, steps_per_chunk)
    state = dtrain.init_loop_state(config, device)
    start = sk.fused_env_step.launches
    dtrain.train_chunk(config, state)
    _sync(device)
    mesh.barrier()
    before = sk.fused_env_step.launches
    t0 = time.perf_counter()
    for _ in range(chunks):
        dtrain.train_chunk(config, state)
    int(state.buffer.size.sum())
    _sync(device)
    mesh.barrier()
    return {"seconds": time.perf_counter() - t0,
            "warm_launches": before - start,
            "launches": sk.fused_env_step.launches - before,
            "train_steps": state.agent.train_steps}


def scale_main(rank_counts, envs_per_rank: int = 256, chunks: int = 4,
               device: Optional[str] = None,
               steps_per_chunk: int = SCALE_STEPS_PER_CHUNK) -> list:
    """Data-parallel scaling of the whole DQN training chunk (the env-step
    kernel on each rank's lanes, sharded replay, an all-reduced update),
    the JAX package's ``scale_main``: for each n, n ranks
    (:func:`tpu2048_torch.parallel.testkit.spawn_ranks`: NCCL a card each,
    gloo on the CPU) run one warm and ``chunks`` timed chunks of
    :func:`scale_config`. One JSON line a count: env-steps/s a rank, the
    efficiency against the first count's and its ratio to the 85% target;
    rows from gloo ranks on the CPU are marked ``"simulated": true`` (they
    check the program, not a card's scaling). Returns the rows."""
    import functools

    from tpu2048_torch.parallel.testkit import spawn_ranks

    device = resolve_device(device)
    base = None
    rows = []
    for n in rank_counts:
        ranks = spawn_ranks(n, functools.partial(
            _scale_rank, n, envs_per_rank, chunks, steps_per_chunk),
            device=device)
        seconds = max(r["seconds"] for r in ranks)
        per_rank = envs_per_rank * steps_per_chunk * chunks / seconds
        base = base or per_rank
        row = {
            "metric": "dp_scaling_env_steps_per_s_per_device",
            "devices": n,
            "value": per_rank,
            "unit": "steps/s/device",
            "efficiency": per_rank / base,
            "vs_baseline": per_rank / base / SCALE_TARGET,
            "envs_per_rank": envs_per_rank,
            "steps_per_chunk": steps_per_chunk,
            "chunks": chunks,
            "seconds": seconds,
            "updates": ranks[0]["train_steps"],
            "launches": [r["launches"] for r in ranks],
            "warm_launches": [r["warm_launches"] for r in ranks],
        }
        if device.type == "cpu":
            row["simulated"] = True
        row["card"] = card_name(device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows
