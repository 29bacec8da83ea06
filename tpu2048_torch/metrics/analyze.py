"""Training-run analysis, the port of :mod:`tpu2048.metrics.analyze`:
milestone timings and win statistics from a run's ``metrics.jsonl``.

The reference's headline learning-quality numbers are episode-indexed
milestones ("2048 reached at episode 1858", the artifact name
dqn_model_2048_2048_1858.h5, GameDemo.py:208) and the max-tile frequency
table (2048.pdf §5.1). This module recovers them from the rows either
package writes::

    python -m tpu2048_torch analyze --log runs/dqn_r3/metrics.jsonl

It imports neither torch nor matplotlib.
"""

from __future__ import annotations

import json
from typing import List, Optional


def load_rows(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def first_row_at_tile(rows: List[dict], tile: int) -> Optional[dict]:
    """First logged row whose running best tile reached ``tile``: an upper
    bound within one chunk's episodes (the rows are per chunk, the
    reference logged per episode)."""
    for row in rows:
        if row.get("best_tile", 0) >= tile:
            return row
    return None


def analyze(path: str) -> dict:
    rows = load_rows(path)
    if not rows:
        return {"error": f"no rows in {path}"}
    last = rows[-1]
    out = {
        "log": path,
        "episodes": last.get("episodes"),
        "env_steps": last.get("env_steps"),
        "best_tile": last.get("best_tile"),
    }
    for tile in (256, 512, 1024, 2048):
        row = first_row_at_tile(rows, tile)
        out[f"first_{tile}_by_episode"] = (None if row is None
                                           else row["episodes"])
        # B games finish in parallel, so the episode axis compresses
        # exploration against the single-env reference: also report the
        # env transitions consumed and the gradient updates taken.
        if row is not None and "env_steps" in row:
            out[f"first_{tile}_by_env_steps"] = row["env_steps"]
        if row is not None and "train_steps" in row:
            out[f"first_{tile}_by_train_steps"] = row["train_steps"]
    hist = last.get("tile_hist")
    if hist:
        # tile_hist[k] = episodes whose final board's max exponent was k.
        total = sum(hist) or 1
        out["games_won_2048"] = sum(hist[11:])
        out["final_tile_distribution"] = {
            str(1 << k): c for k, c in enumerate(hist) if c and k > 0
        }
        out["win_rate"] = round(sum(hist[11:]) / total, 4)
    if "train_steps" in last:
        out["train_steps"] = last["train_steps"]
    if "mean_score" in last:
        # Late-training score: the mean of the last 10 chunk rows.
        tail = rows[-10:]
        out["late_mean_score"] = round(
            sum(r.get("mean_score", 0.0) for r in tail) / len(tail), 1)
    if "dropped_updates" in last:
        out["dropped_updates"] = last["dropped_updates"]
    if "rollbacks" in last:
        # Rollback-on-regression (mainDQL:278-314): the restores, and the
        # episodes rewound and replayed in all (the episode count drops at
        # each restore).
        out["rollbacks"] = last["rollbacks"]
        eps = [r["episodes"] for r in rows]
        out["episodes_replayed"] = sum(
            a - b for a, b in zip(eps, eps[1:]) if a > b)
    if "action_counts" in last:
        ac = last["action_counts"]
        tot = sum(ac) or 1
        out["action_fractions"] = {
            k: round(c / tot, 4) for k, c in zip("LURD", ac)
        }
    if "train_steps" in last:
        # The reference's one published DQN result on every axis above:
        # first 2048 at episode 1858 (GameDemo.py:208; 2048.pdf §5.1), at
        # 100 updates an episode and ~165 steps an episode ~307k env
        # transitions and ~186k gradient updates.
        out["reference_anchor"] = {
            "first_2048_by_episode": 1858,
            "first_2048_by_env_steps": 307_000,
            "first_2048_by_train_steps": 186_000,
            "source": "dqn_model_2048_2048_1858.h5 (GameDemo.py:208); "
                      "2048.pdf §5.1",
        }
    return out


def main(path: str) -> None:
    print(json.dumps(analyze(path), indent=2))
