"""The harness's data: ``BENCHMARK.json`` and the files it names, found by
name, and the pieces every driver shares.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The harness reads:

* ``configs/<config>.json`` (the configuration's ``file``): its sizes and
  the name of its plain reference under ``reference/``;
* ``traffic/<traffic>.json``: the driver under ``drivers/`` that plays
  the mix, and the mix's parameters;
* ``workloads/<cell>.json``: the cell's own limits of the comparison that
  decides ``correct``, and the bound of its traced part;
* ``metrics/<metric>.py`` for each per-layer metric: ``read(summary)``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu2048")


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A Python file of the benchmark, imported under a private name."""
    path = Path(path).resolve()
    name = "_bench_" + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``tpu2048_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = root / "benchmark"
        self.manifest = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it "
                           f"has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.own = load_json(bench / "workloads" / f"{name}.json")
        self.driver_path = bench / "drivers" / f"{self.traffic['driver']}.py"
        self.reference_path = (bench / "reference"
                               / f"{self.config['reference']}.py")
        self.bench = bench

    def metrics(self, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py")

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use (``tags``) of the run's ``seed``."""
    seq = np.random.SeedSequence(int(seed), spawn_key=tuple(tags))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def weights(ref, cfg, device):
    """The reference's seeded weights of ``cfg``, made on ``device`` from
    the configuration's own ``weights_seed``: the weights are part of the
    configuration, the same in every run."""
    return ref.make_weights(cfg, int(cfg["weights_seed"]), device)


class Recording:
    """A call source wrapped so that each result is kept while ``on``: the
    results are the program's random inputs (fresh tensors, kept by
    reference, so no copy runs on the device)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: List = []
        self.on = True

    def __call__(self, *args):
        out = self.inner(*args)
        if self.on:
            self.calls.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def check_line(checks: List) -> Dict:
    """``{name: {"value": v, "limit": l}}`` in order."""
    return {n: {"value": v, "limit": lim} for n, v, lim in checks}


def passes(checks: List) -> bool:
    return all(v is not None and v <= lim for _, v, lim in checks)
