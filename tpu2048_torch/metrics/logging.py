"""Metric logs and plots, the port of :mod:`tpu2048.metrics.logging`.

Training writes JSON rows (:class:`JSONLLogger`); ``train dqn --debug-csv``
writes the reference's per-step CSV (:class:`CSVLogger`); the 3-panel
training plot is drawn from the JSON rows (:func:`plot_training`,
:func:`plot_from_jsonl`), with matplotlib imported only there, on its Agg
backend. The rows are the JAX package's, so each package reads the other's
logs. Data parallel, only rank 0's loggers write and echo, as the JAX
loggers write on host 0 only; the others' files are never made.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Iterable, List, Optional

from tpu2048_torch.parallel.mesh import is_primary_host


class JSONLLogger:
    """Append metric dicts as JSON lines; optional stdout echo."""

    def __init__(self, path: Optional[str], echo: bool = True):
        self.path = path
        self.echo = echo
        self.enabled = is_primary_host()
        self._fh = None
        if path and self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # Append: a resumed run continues the same metrics file.
            self._fh = open(path, "a", buffering=1)

    def log(self, row: dict) -> None:
        if not self.enabled:
            return
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
        if self.echo:
            parts = []
            for k, v in row.items():
                if isinstance(v, float):
                    parts.append(f"{k}={v:.4g}")
                elif not isinstance(v, list):
                    parts.append(f"{k}={v}")
            print(" ".join(parts), flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


class CSVLogger:
    """Reference-style CSV appender (Agent/main.py:59-62; mainDQL:22-25):
    the header once, when the file is new; rank 0 only."""

    def __init__(self, path: str, header: List[str]):
        self.path = path
        self._fh = None
        if not is_primary_host():
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        new = not os.path.exists(path)
        self._fh = open(path, "a", newline="", buffering=1)
        self._writer = csv.writer(self._fh)
        if new:
            self._writer.writerow(header)

    def log(self, row: Iterable) -> None:
        if self._fh:
            self._writer.writerow(list(row))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def plot_training(
    rows: List[dict],
    out_path: str,
    keys=("best_tile", "mean_score", "loss"),
    titles=("Max Tile per Game", "Score per Game", "Loss per Game"),
) -> None:
    """3-panel training plot (the reference's ``plot_results``,
    mainDQL:27-53), drawn from JSON rows into a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = [r.get("episodes", i) for i, r in enumerate(rows)]
    fig, axes = plt.subplots(len(keys), 1, figsize=(12, 12))
    for ax, key, title in zip(axes, keys, titles):
        ax.plot(x, [r.get(key, float("nan")) for r in rows])
        ax.set_title(title)
        ax.set_xlabel("Episodes")
        ax.set_ylabel(key)
    fig.subplots_adjust(hspace=0.5)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)


def plot_from_jsonl(jsonl_path: str, out_path: str) -> None:
    plot_training(read_jsonl(jsonl_path), out_path)
