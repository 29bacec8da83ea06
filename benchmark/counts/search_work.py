"""The work of depth-D expectimax trees over the n-tuple network
(``csrc/expectimax_kernel.cu``), counted from their root boards by a plain
enumeration that shares nothing with the kernels, and the kernels' names as
the profiler gives them.

A tree's leaves are the afterstates of the legal moves of its max nodes at
depth D; the chance nodes below each afterstate of the layers above put a 2
or a 4 on each empty cell (``reference/ntuple_expectimax.py``). What a step
of the search needs at least:

* bytes: 4 for each distinct weight that the step's trees read (a weight
  read by many leaves, or by many roots, is read once), plus each root's
  board in (16), its four values out (16) and its action (4);
* operations: 32 float32 adds (one a lookup) for each distinct leaf
  afterstate of each root's tree (a board that two paths of one tree reach
  is valued once), at the card's rate of float32 adds: one a clock on each
  of an SM's 128 float32 lanes, 33.5e12 a second on an H100 SXM's 132 SMs
  at 1,980 MHz (the data sheet's 67e12 counts a fused multiply-add as two
  operations, and a sum of lookups has no multiply).

A kernel that reuses lookups through L1 or registers cannot read above its
least time on these counts, where a count of every lookup would let it. The
leaves' integer work (a move, and the index of each lookup) is not counted:
how few operations make an index depends on how the board lies in the
registers (a pattern's cells side by side in a packed board are one shift
and one mask), so no count of it bounds every kernel.

A step of the search is two kernels, the unit kernel and then the root
kernel; :func:`steps_time_s` times chosen steps of a trace by their order.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import torch

from benchmark.counts import peaks
from benchmark.reference import game
from benchmark.reference import ntuple as nref

F32_ADDS_PER_S = 33.5e12  # float32 adds outside the tensor cores, H100 SXM
ROOT_BYTES = 16 + 16 + 4
WEIGHT_BYTES = 4
ROOTS = 64  # roots a block of the enumeration

_SEARCH = re.compile(r"^(\(anonymous namespace\)::)?expectimax_"
                     r"(unit|root)_kernel\(")


def is_search(name: str) -> bool:
    return bool(_SEARCH.match(name))


def steps_time_s(kernels, steps, n_steps: int):
    """Device seconds of the search kernels of ``steps`` (indices of the
    trace's search steps, in order) among ``kernels`` (``(name, start,
    duration)`` in microseconds); None unless the trace holds one unit
    and one root kernel for each of its ``n_steps`` steps."""
    found = {"unit": [], "root": []}
    for name, start, d in kernels:
        m = _SEARCH.match(name)
        if m:
            found[m.group(2)].append((start, d))
    units, roots = (sorted(found[k]) for k in ("unit", "root"))
    if len(units) != n_steps or len(roots) != n_steps:
        return None
    return sum(units[i][1] + roots[i][1] for i in steps) / 1e6


def _children(after: torch.Tensor, owner: torch.Tensor):
    """Every chance child of ``(L, 16)`` afterstates (each empty cell, a
    2 and a 4) and the root each comes from."""
    rows, cells = (after == 0).nonzero(as_tuple=True)
    out, owners = [], []
    for tile in (1, 2):
        child = after[rows]
        child[torch.arange(rows.shape[0], device=after.device), cells] = tile
        out.append(child)
        owners.append(owner[rows])
    return torch.cat(out), torch.cat(owners)


def leaves(roots: torch.Tensor, depth: int):
    """Every leaf afterstate of the trees of ``(N, 16)`` int64 roots, with
    the index of its root: ``((M, 16), (M,))``."""
    boards = roots
    owner = torch.arange(roots.shape[0], device=roots.device)
    for level in range(1, depth + 1):
        after, _, moved = game.all_moves(boards)
        owner = owner[None].expand(4, -1)[moved]
        after = after[moved]
        if level == depth:
            return after, owner
        boards, owner = _children(after, owner)
    raise ValueError(f"depth must be at least 1, not {depth}")


def _pack(boards: torch.Tensor) -> torch.Tensor:
    """A board's exponents clipped at 15 as one int64, a nibble a cell: two
    boards that the network reads alike are one key."""
    e = boards.clamp(0, 15)
    shifts = 4 * torch.arange(16, device=boards.device)
    return (e << shifts).sum(1)


def _distinct(owner: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Which of the (owner, key) pairs is the first of its kind."""
    key, order = torch.sort(key, stable=True)
    owner, order2 = torch.sort(owner[order], stable=True)
    key = key[order2]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = (owner[1:] != owner[:-1]) | (key[1:] != key[:-1])
    return first, order[order2]


def step_work(roots: torch.Tensor, patterns: Sequence[Sequence[int]],
              depth: int, roots_per_block: int = ROOTS) -> Dict[str, int]:
    """One step's trees: ``leaves`` (every leaf), ``distinct_leaves`` (in
    each root's tree) and ``distinct_weights`` (over the whole step)."""
    k = len(patterns[0])
    read = torch.zeros(len(patterns) * 16 ** k, dtype=torch.bool,
                       device=roots.device)
    found = nref.lookups(patterns)
    total = distinct = 0
    for i in range(0, roots.shape[0], roots_per_block):
        after, owner = leaves(roots[i:i + roots_per_block], depth)
        total += after.shape[0]
        first, order = _distinct(owner, _pack(after))
        distinct += int(first.sum())
        kept = after[order[first]]
        for p, cells in found:
            read[nref.index(kept, p, cells, k)] = True
    return dict(leaves=total, distinct_leaves=distinct,
                distinct_weights=int(read.sum()))


def search_bytes(roots: int, distinct_weights: int) -> int:
    return roots * ROOT_BYTES + distinct_weights * WEIGHT_BYTES


def search_ops(distinct_leaves: int, lookups: int) -> int:
    return distinct_leaves * lookups


def least_s(n_bytes: int, n_ops: int):
    """The least time of the work and the term that sets it."""
    by_bytes = n_bytes / peaks.HBM_BYTES_PER_S
    by_ops = n_ops / F32_ADDS_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                               "bytes")
