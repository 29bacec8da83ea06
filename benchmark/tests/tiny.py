"""A copy of the benchmark at test sizes, in a temporary directory: the
same files, with the configurations, the traffic and the cells' bounds
cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import core

CONFIGS = {
    "dqn_cnn_ref": dict(features=16, hidden=32, memory_size=2000),
    "tabular_qtable_ref": dict(capacity_log2=12),
}
TRAFFIC = {
    "train_dqn_defaults": dict(num_envs=8, train_batch=8,
                               updates_per_episode=4,
                               max_updates_per_step=8, steps_per_chunk=4),
    "train_tabular_defaults": dict(lanes=16, steps_per_chunk=8,
                                   fill=dict(lanes=64, steps=64, keys=2650)),
    "eval_greedy_512": dict(games=16, batch=16, max_steps=256),
    "play_model_batch1": dict(warm_moves=8),
}
# The network at test sizes reads larger gaps against the float32
# reference than at its own (gradient and update gaps up to 0.11 and 0.31 on
# three seeds): with so few units, the ReLUs that bf16 rounding switches
# are a larger share of each leaf. Its faults read a loss gap of 0.7 and
# more (half the batch left out) and 1 (Adam's step left out).
CELLS = {
    "dqn_train": dict(setup_max_chunks=200,
                      limits=dict(actor_q_gap=0.01, loss_gap=1e-3,
                                  grad_norm_gap=0.3, update_norm_gap=0.6),
                      trace=dict(min_vector_steps=2, min_updates=4,
                                 max_vector_steps=8)),
    "tabular_train": dict(trace=dict(steps=4)),
    "dqn_eval_greedy": dict(trace=dict(calls=1), q_positions=256),
    "dqn_play": dict(trace=dict(moves=64)),
}


def _edit(path: Path, changes) -> None:
    data = core.load_json(path)
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data, indent=1))


def make(root: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` under ``root`` and cut
    them to test sizes; returns ``root``."""
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(core.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    for name, changes in CONFIGS.items():
        if (bench / "configs" / f"{name}.json").exists():
            _edit(bench / "configs" / f"{name}.json", changes)
    for name, changes in TRAFFIC.items():
        if (bench / "traffic" / f"{name}.json").exists():
            _edit(bench / "traffic" / f"{name}.json", changes)
    for name, changes in CELLS.items():
        if (bench / "workloads" / f"{name}.json").exists():
            _edit(bench / "workloads" / f"{name}.json", changes)
    return root
