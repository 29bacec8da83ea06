"""The plain reference of depth-D expectimax over the n-tuple network: plain
PyTorch in the weights' dtype (float32), with no kernel and no batching
trick, level by level from the equations.

The search (Yeh et al., arXiv:1606.07374, and Jaskowski, IEEE Transactions
on Games 2018, play their n-tuple networks under it). ``V`` is the
network's afterstate value (the n-tuple reference's ``value``), ``r(s,
a)`` a move's merge score, and a spawn puts a 2 (exponent 1) with p = 0.9
or a 4 (exponent 2) with p = 0.1 on an empty cell drawn uniformly. Depth
``D`` counts the max layers:

* ``M_k(s) = max over legal a of r(s, a) + C_k(after(s, a))``, and 0 where
  no move is legal;
* ``C_k(b) = V(b)`` at ``k = D``;
* else ``C_k(b)`` is the sum over the ``n`` empty cells ``e`` of ``b`` and the
  tiles ``t`` of ``(p_t / n) * M_{k+1}(b with t at e)``.

A root's four values are ``r + C_1`` of its moves (-inf where illegal), its
action the first maximum (0 where no move is legal). ``D = 1`` is the greedy
afterstate policy. The leaves are the legal moves of the max nodes at depth
``D``: each is one afterstate that ``V`` values.

Departures from the sources: the tree is exact, every node expanded with no
pruning, probability cut-off or transposition table (Jaskowski's search
caches the values of boards it has seen; the values are the same, the work
is not), and ``D`` counts max layers, since the sources count their plies
differently. ``spawns`` and ``depth`` let a test plant a fault (another
spawn law, a shallower tree). Weights given in bfloat16 are summed in
bfloat16 (the control).
"""

from __future__ import annotations

import torch

import ntuple_reference as ref

SPAWNS = ((1, 0.9), (2, 0.1))  # (exponent, probability) of a spawned tile
ROOTS = 16  # roots a block: a depth-3 tree has up to 57,600 leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def chance_children(after: torch.Tensor, spawns=SPAWNS):
    """The chance children of ``(N, 16)`` afterstates, one group for each
    cell and tile: ``(children, groups)``, the children ``(M, 16)`` group
    after group, and for each group the parents it comes from (an ``(N,)``
    mask, the cell empty) and the tile's probability."""
    children, groups = [], []
    for cell in range(16):
        has = after[:, cell] == 0
        for tile, p in spawns:
            child = after[has].clone()
            child[:, cell] = tile
            children.append(child)
            groups.append((has, p))
    return torch.cat(children), groups


def max_layer(weights, patterns, boards, level: int, depth: int,
              spawns=SPAWNS):
    """``(4, N)`` ``r + C_level`` of each move of ``(N, 16)`` boards in the
    weights' dtype (-inf where illegal), and ``(N,)`` the leaves of each
    board's tree."""
    after, rewards, legal = ref.afterstates(boards)
    n = boards.shape[0]
    chance = torch.zeros((4, n), dtype=weights.dtype, device=boards.device)
    leaves = torch.zeros(n, dtype=torch.int64, device=boards.device)
    for d in range(4):
        live = legal[d]
        if level == depth:
            chance[d, live] = ref.value(weights, patterns, after[d][live])
            leaves += live.to(torch.int64)
            continue
        empty = (after[d][live] == 0).sum(1).to(weights.dtype)
        children, groups = chance_children(after[d][live], spawns)
        q, below = max_layer(weights, patterns, children, level + 1, depth,
                             spawns)
        m = torch.where(torch.isfinite(q).any(0), q.max(0).values,
                        torch.zeros_like(q[0]))
        sums = torch.zeros(int(live.sum()), dtype=weights.dtype,
                           device=boards.device)
        counts = torch.zeros_like(sums, dtype=torch.int64)
        at = 0
        for has, p in groups:
            k = int(has.sum())
            sums[has] += p / empty[has] * m[at:at + k]
            counts[has] += below[at:at + k]
            at += k
        chance[d, live] = sums
        leaves[live] += counts
    q = torch.where(legal, rewards.to(weights.dtype) + chance, -torch.inf)
    return q, leaves


def first_max(values: torch.Tensor) -> torch.Tensor:
    """``(N,)`` the first maximum of ``(4, N)`` values (0 where all are
    -inf)."""
    action = torch.zeros(values.shape[1], dtype=torch.int64,
                         device=values.device)
    best = values[0].clone()
    for a in range(1, 4):
        better = values[a] > best
        action = torch.where(better, a, action)
        best = torch.where(better, values[a], best)
    return action


def search(weights, patterns, boards, depth: int, spawns=SPAWNS,
           roots: int = ROOTS):
    """Depth-``depth`` expectimax of ``(N, 16)`` int64 root boards, in
    blocks of ``roots`` roots: a dict of the ``(4, N)`` root values, the
    ``(N,)`` actions and the ``(N,)`` leaves of each root's tree."""
    values, leaves = [], []
    for i in range(0, boards.shape[0], roots):
        q, n = max_layer(weights, patterns, boards[i:i + roots], 1, depth,
                         spawns)
        values.append(q)
        leaves.append(n)
    values = torch.cat(values, 1)
    return dict(values=values, action=first_max(values),
                leaves=torch.cat(leaves))
