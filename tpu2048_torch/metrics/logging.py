"""JSONL metric rows, the port of :mod:`tpu2048.metrics.logging`
(``JSONLLogger`` and ``read_jsonl``).

The rows are the JAX package's, so its ``metrics/analyze.py`` reads the
port's logs. The port runs in one process, so every logger writes (the JAX
logger writes on host 0 only).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional


class JSONLLogger:
    """Append metric dicts as JSON lines; optional stdout echo."""

    def __init__(self, path: Optional[str], echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # Append: a resumed run continues the same metrics file.
            self._fh = open(path, "a", buffering=1)

    def log(self, row: dict) -> None:
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
