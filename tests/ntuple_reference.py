"""The plain reference of the n-tuple network trained by TD(0) on
afterstates: plain PyTorch in float32, with no kernel and no batching trick.

Network (Yeh et al., arXiv:1606.07374; Szubert & Jaskowski, IEEE CIG 2014):
patterns of row-major board cells, cell 0 at the top left, each with a
table of ``16**k`` weights indexed by ``sum_j e[cell_j] * 16**j``, where
``e`` is a cell's tile exponent clipped at 15. Each pattern is read under
the board's 8 symmetries; the value of a board is the sum of the
``len(patterns) * 8`` weights read. The weights are one flat tensor,
pattern after pattern.

Boards are ``(N, 16)`` int64 tile exponents (0 = empty). Actions: 0 left,
1 up, 2 right, 3 down. A move slides each line toward the wall and merges
each equal pair once, the pair nearest the wall first; its reward is the
sum of the merged tiles' values, and it is legal where it changes the
board.

One batched step of :func:`td_step`, for every lane at once:

1. the four afterstates (slid boards, no spawn), their rewards and
   legality, and ``V`` of each legal afterstate (-inf where illegal) and of
   the lane's previous afterstate (0 where it has none), all at the weights
   before the step;
2. the greedy action, ``argmax(reward + V(after))`` over the legal moves,
   ties to the lowest index (0 where no move is legal);
3. the previous afterstate's target: 0 where the previous step ended its
   game or no move is legal, else ``reward[a] + V(after[a])`` (gamma = 1);
4. for each lane with a previous afterstate, the update
   ``alpha * (target - V(prev)) / L`` for each of its ``L`` lookups. The
   lanes read before any lane writes; the updates that land on one weight
   in one step are averaged (their sum over their count) and added to it.

Weights given in bfloat16 are held and summed in bfloat16 (the control);
``syms`` reads fewer than the 8 symmetries (a planted fault).
"""

from __future__ import annotations

import torch

# Board cells of each line, toward the wall first, for each direction.
LINES = (
    [[4 * r + c for c in range(4)] for r in range(4)],
    [[4 * r + c for r in range(4)] for c in range(4)],
    [[4 * r + 3 - c for c in range(4)] for r in range(4)],
    [[4 * (3 - r) + c for r in range(4)] for c in range(4)],
)


def _transform(rot: int, mirror: bool):
    """The board cell read at each cell by a rotation of ``rot`` quarter
    turns, after a reflection in the main diagonal where ``mirror``."""
    out = []
    for cell in range(16):
        r, c = divmod(cell, 4)
        for _ in range(rot):
            r, c = c, 3 - r
        if mirror:
            r, c = c, r
        out.append(4 * r + c)
    return out


SYMMETRIES = [_transform(rot, mirror) for mirror in (False, True)
              for rot in range(4)]


def lookups(patterns, syms: int = 8):
    """``(pattern, cells)`` of every lookup: each pattern's cells as read
    on each of the first ``syms`` transforms of the board."""
    return [(p, [SYMMETRIES[s][c] for c in cells])
            for p, cells in enumerate(patterns) for s in range(syms)]


def slide_left(lines: torch.Tensor):
    """``(N, 4)`` lines slid toward index 0: ``(lines, reward)``. Walks the
    cells in order with one pending tile: an equal tile merges with it and
    writes the merged tile, another writes the pending one and waits."""
    n = lines.shape[0]
    out = torch.zeros_like(lines)
    reward = torch.zeros(n, dtype=torch.int64, device=lines.device)
    at = torch.zeros(n, dtype=torch.int64, device=lines.device)
    pending = torch.zeros(n, dtype=torch.int64, device=lines.device)
    rows = torch.arange(n, device=lines.device)
    for k in range(4):
        x = lines[:, k]
        merge = (x != 0) & (pending == x)
        flush = (x != 0) & (pending != 0) & ~merge
        put = merge | flush
        value = torch.where(merge, pending + 1, pending)
        out[rows[put], at[put]] = value[put]
        reward = reward + torch.where(merge, 2 ** (pending + 1), 0)
        at = at + put.to(torch.int64)
        pending = torch.where(merge, 0, torch.where(x != 0, x, pending))
    last = pending != 0
    out[rows[last], at[last]] = pending[last]
    return out, reward


def afterstates(boards: torch.Tensor):
    """``(4, N, 16)`` afterstates, ``(4, N)`` int64 rewards and ``(4, N)``
    legality of ``(N, 16)`` boards."""
    after = torch.empty((4,) + boards.shape, dtype=boards.dtype,
                        device=boards.device)
    rewards, legal = [], []
    for d, lines in enumerate(LINES):
        reward = 0
        for cells in lines:
            moved, r = slide_left(boards[:, cells])
            after[d][:, cells] = moved
            reward = reward + r
        rewards.append(reward)
        legal.append((after[d] != boards).any(1))
    return after, torch.stack(rewards), torch.stack(legal)


def index(boards: torch.Tensor, pattern: int, cells, k: int):
    """Flat weight indices of one lookup on ``(N, 16)`` boards."""
    e = boards.clamp(0, 15).to(torch.int64)
    idx = torch.full_like(e[:, 0], pattern * 16 ** k)
    for j, cell in enumerate(cells):
        idx = idx + e[:, cell] * 16 ** j
    return idx


def value(weights: torch.Tensor, patterns, boards: torch.Tensor,
          syms: int = 8):
    """``(N,)`` values of ``(N, 16)`` boards, summed lookup by lookup in
    the weights' dtype."""
    k = len(patterns[0])
    v = torch.zeros(boards.shape[0], dtype=weights.dtype,
                    device=boards.device)
    for p, cells in lookups(patterns, syms):
        v = v + weights[index(boards, p, cells, k)]
    return v


def greedy(rewards, values, legal):
    """The greedy action of each lane and its ``reward + V``: the first
    maximum over the legal moves; action 0 and -inf where none is legal."""
    q = torch.where(legal, rewards.to(values.dtype) + values, -torch.inf)
    action = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    best = q[0].clone()
    for a in range(1, 4):
        better = q[a] > best
        action = torch.where(better, a, action)
        best = torch.where(better, q[a], best)
    return action, best


def td_step(weights: torch.Tensor, patterns, boards, prev_after, prev_valid,
            prev_terminal, alpha: float, action=None, syms: int = 8):
    """One batched TD(0) step on every lane; ``weights`` (flat) is updated
    in place. With ``action`` given, the step takes those actions instead
    of its greedy ones. Returns the afterstates, rewards and legality, the
    values of the afterstates (-inf where illegal) and of the previous
    afterstates, the greedy actions, the actions taken, the targets and the
    taken afterstates."""
    n = boards.shape[0]
    after, rewards, legal = afterstates(boards)
    values = torch.stack([value(weights, patterns, after[d], syms)
                          for d in range(4)])
    values = torch.where(legal, values, -torch.inf)
    v_prev = torch.where(prev_valid, value(weights, patterns, prev_after,
                                           syms), 0.0)
    greedy_action, _ = greedy(rewards, values, legal)
    taken = greedy_action if action is None else action
    lanes = torch.arange(n, device=boards.device)
    best = rewards[taken, lanes].to(values.dtype) + values[taken, lanes]
    ends = prev_terminal | ~legal.any(0)
    target = torch.where(ends, torch.zeros_like(best), best)
    delta = torch.where(prev_valid, target - v_prev, torch.zeros_like(best))
    found = lookups(patterns, syms)
    step = alpha * delta / len(found)
    k = len(patterns[0])
    live = prev_valid
    idx = torch.cat([index(prev_after[live], p, cells, k)
                     for p, cells in found])
    adds = step[live].repeat(len(found))
    total = torch.zeros_like(weights).index_put_((idx,), adds,
                                                  accumulate=True)
    count = torch.zeros(weights.shape, dtype=torch.int64,
                        device=weights.device).index_put_(
        (idx,), torch.ones_like(idx), accumulate=True)
    hit = count > 0
    weights[hit] = weights[hit] + total[hit] / count[hit].to(weights.dtype)
    return dict(after=after, rewards=rewards, legal=legal, values=values,
                v_prev=v_prev, greedy=greedy_action, action=taken,
                target=target, chosen=after[taken, lanes], written=hit)
