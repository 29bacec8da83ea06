"""Audit a saved Q-table (``.npz`` of either package) for entries that a
correct bucketed table cannot hold, and print one JSON line.

    python scripts/qtable_audit.py runs/tabular_200k_r5/qtable.npz

Counts, over the table's ``2**N`` slots:

- ``occupied``: slots with a non-zero key, and ``dropped`` as stored;
- ``misplaced``: occupied slots outside the bucket their key hashes to
  (no lookup reaches them);
- ``duplicate_keys``: occupied slots less the distinct keys they hold (a
  key held in two slots counts once);
- ``orphan_q``: empty slots whose Q row is not all zero (an update whose
  key was never written);
- ``zero_q``: occupied slots whose Q row is all zero.

A table trained by a correct update has no misplaced, duplicate or orphan
entry. The table is read with :func:`tpu2048_torch.agents.tabular.load_qtable`
(a linear-layout file is rehashed first) on the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpu2048_torch.agents import tabular as tab  # noqa: E402


def audit(table: tab.QTable) -> dict:
    occ = table.occupied
    slots = torch.arange(table.capacity)
    bucket = tab._hash(table.key_lo, table.key_hi,
                       table.capacity // tab.PROBES)
    keys = ((table.key_lo[occ].to(torch.int64) & 0xFFFFFFFF)
            | (table.key_hi[occ].to(torch.int64) << 32))
    zero_q = (table.q == 0).all(1)
    return {
        "capacity": table.capacity,
        "occupied": int(occ.sum()),
        "dropped": int(table.dropped),
        "misplaced": int((occ & (bucket != slots // tab.PROBES)).sum()),
        "duplicate_keys": keys.numel() - torch.unique(keys).numel(),
        "orphan_q": int((~occ & ~zero_q).sum()),
        "zero_q": int((occ & zero_q).sum()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("table", help="a .npz written by save_qtable")
    args = ap.parse_args(argv)
    row = {"table": args.table, **audit(tab.load_qtable(args.table))}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
