"""Throughput benchmarks of the port on one card, each printing one JSON line
(the counterpart of the repository root's ``bench.py``, which measures the
JAX package).

``main`` times the random-policy env on the rollout kernel: ``steps`` env
steps of ``batch`` lanes as ``steps / rollout_k`` launches of
:func:`tpu2048_torch.env.fast.fast_rollout`, with the bits drawn by Philox
inside the kernel. ``tabular_main`` times the tabular training chunk (shaped
fast env, packed hashed Q-table, the step, gather and scatter kernels).

Each warms up with the same work it then times, and fences the timed run by
synchronizing the device and reading a result on the host. Each line names
the card and its power limit (``nvidia-smi``), or ``"cpu"``. Run them as
``python -m tpu2048_torch bench [--tabular] [--cpu]``.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Optional

import torch

from tpu2048_torch.env.fast import (FastEnvConfig, PhiloxBits, fast_reset,
                                    fast_rollout)
from tpu2048_torch.ops import step_kernel as sk
from tpu2048_torch.utils.device import resolve_device

# The JAX bench's env: simple reward with the terminal bonus.
ROLLOUT_ENV = FastEnvConfig(terminal_bonus=True)
# The JAX bench's tabular shape: table capacity 2**24, 256 steps a chunk,
# one warm chunk and then the timed ones.
TABULAR_CAPACITY_LOG2 = 24
TABULAR_STEPS_PER_CHUNK = 256
TABULAR_TIMED_CHUNKS = 4


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
    """Random-policy env-steps/s on the rollout kernel; returns the printed
    row. ``launches`` counts the kernel launches of the timed run (0 on the
    CPU, where the plain version runs)."""
    device = resolve_device(device)
    if steps % rollout_k:
        raise ValueError(f"steps {steps} not divisible by k {rollout_k}")
    windows = steps // rollout_k
    config = ROLLOUT_ENV
    bits = PhiloxBits(0, device)
    state = fast_reset(bits, batch, config)

    def run(state):
        reward = torch.zeros((), dtype=torch.float32, device=device)
        dones = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(windows):
            state, reward_sum, done_count = fast_rollout(config, state, bits,
                                                         rollout_k)
            reward += reward_sum.sum(dtype=torch.float32)
            dones += done_count.sum()
        return state, reward, dones

    state, reward, _ = run(state)
    float(reward)
    _sync(device)
    before = sk.fused_env_rollout.launches
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
        "launches": sk.fused_env_rollout.launches - before,
        "bits": "philox",
        "episodes": int(dones),
        "seconds": seconds,
        "card": card_name(device),
    }
    print(json.dumps(row))
    return row


def tabular_main(batch: int = 4096, device: Optional[str] = None) -> dict:
    """Tabular training env-steps/s and ms a step at the JAX bench's shape:
    one warm chunk, then ``TABULAR_TIMED_CHUNKS`` timed ones; returns the
    printed row."""
    from tpu2048_torch.agents.tabular import TabularConfig
    from tpu2048_torch.training import tabular as ttrain

    device = resolve_device(device)
    capacity_log2, chunks = TABULAR_CAPACITY_LOG2, TABULAR_TIMED_CHUNKS
    steps_per_chunk = TABULAR_STEPS_PER_CHUNK
    config = ttrain.TabularTrainConfig(
        agent=TabularConfig(capacity_log2=capacity_log2, total_epochs=100),
        batch_size=batch,
        steps_per_chunk=steps_per_chunk,
    )
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
        "steps_per_chunk": steps_per_chunk,
        "chunks": chunks,
        "seconds": seconds,
        "card": card_name(device),
    }
    print(json.dumps(row))
    return row
