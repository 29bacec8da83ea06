"""The rules of 2048 in plain PyTorch, written from the game and from the
random conventions that the configurations state.

Boards are ``(B, 16)`` int64 tensors of tile exponents (0 = empty, 1 = a 2),
cells in row-major order. Actions: 0 left, 1 up, 2 right, 3 down. A move
slides each line toward the wall and merges each equal pair once, the pair
nearest the wall first; its score is the sum of the merged tiles' values.

Two spawn conventions:

* kernel words: a step draws eight 32-bit words a lane, in the rows action
  pick, unused, spawn cell, spawn value, reset cell 1, reset cell 2, reset
  value 1, reset value 2. A cell index in ``[0, n)`` is the unsigned word
  shifted right by one, modulo ``max(n, 1)``; a tile is a 2 where the
  unsigned word modulo 10 is below 9, else a 4. A fresh board puts its two
  tiles on cell ``p1`` (of 16) and on the ``p2``-th of the other 15 cells.
* uniforms: two float32 uniforms a spawn, the cell ``floor(u * n)`` of the
  ``n`` empty cells (at most ``n - 1``) and a 2 where the second is below
  0.9; a fresh board is two spawns on the empty board, uniform rows
  ``(cell 1, cell 2, value 1, value 2)``.
"""

from __future__ import annotations

import torch

# Cells of each line in the order a move reads them, toward the wall first.
_LINES = {
    0: [[r * 4 + c for c in range(4)] for r in range(4)],
    1: [[r * 4 + c for r in range(4)] for c in range(4)],
    2: [[r * 4 + c for c in reversed(range(4))] for r in range(4)],
    3: [[r * 4 + c for r in reversed(range(4))] for c in range(4)],
}


def slide(lines: torch.Tensor):
    """Lines ``(N, 4)`` moved toward the wall (index 0): ``(cells, score,
    changed)``."""
    order = torch.argsort((lines == 0).to(torch.int8), dim=1, stable=True)
    c = lines.gather(1, order)
    score = torch.zeros(lines.shape[0], dtype=torch.int64,
                        device=lines.device)
    for i in range(3):
        merge = (c[:, i] != 0) & (c[:, i] == c[:, i + 1])
        c[:, i] = torch.where(merge, c[:, i] + 1, c[:, i])
        score = score + torch.where(merge, torch.ones_like(score) << c[:, i],
                                    0)
        for j in range(i + 1, 3):
            c[:, j] = torch.where(merge, c[:, j + 1], c[:, j])
        c[:, 3] = torch.where(merge, 0, c[:, 3])
    return c, score, (c != lines).any(1)


def all_moves(board: torch.Tensor):
    """``(4, B, 16)`` boards after each move, ``(4, B)`` scores and
    ``(4, B)`` whether each move changes the board."""
    b = board.shape[0]
    lines = torch.tensor([_LINES[d] for d in range(4)], dtype=torch.int64,
                         device=board.device)  # (4 dirs, 4 lines, 4 cells)
    cells, score, moved = slide(board[:, lines].reshape(-1, 4))
    cells = cells.reshape(b, 4, 16)
    out = torch.empty((4, b, 16), dtype=torch.int64, device=board.device)
    for d in range(4):
        out[d].scatter_(1, lines[d].reshape(1, 16).expand(b, 16), cells[:, d])
    return (out, score.reshape(b, 4, 4).sum(-1).T,
            moved.reshape(b, 4, 4).any(-1).T)


def pick(moves, action: torch.Tensor):
    """The chosen move's board, score and changed flag from
    :func:`all_moves`'s results."""
    boards, scores, moved = moves
    a = action.to(torch.int64)
    lanes = torch.arange(a.shape[0], device=a.device)
    return boards[a, lanes], scores[a, lanes], moved[a, lanes]


def legal(board: torch.Tensor) -> torch.Tensor:
    """``(B, 4)`` bool: the moves that change each board."""
    return all_moves(board)[2].T


def spawn_at(board: torch.Tensor, index: torch.Tensor,
             value: torch.Tensor) -> torch.Tensor:
    """``value`` on the ``index``-th empty cell (row-major) of each board; a
    board without that cell is returned as it is."""
    empty = board == 0
    rank = empty.to(torch.int64).cumsum(1) - 1
    hit = empty & (rank == index[:, None].to(torch.int64))
    return torch.where(hit, value[:, None].to(torch.int64), board)


def top_two(board: torch.Tensor):
    """The largest exponent and the largest of the other 15 cells (one
    cell of the largest left out)."""
    mx, at = board.max(1)
    rest = board.scatter(1, at[:, None], -1)
    return mx, rest.max(1).values.clamp_min(0)


def _unsigned(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & 0xFFFFFFFF


def word_index(words: torch.Tensor, n) -> torch.Tensor:
    n = torch.as_tensor(n, device=words.device).clamp_min(1)
    return (_unsigned(words) >> 1) % n


def word_tile(words: torch.Tensor) -> torch.Tensor:
    return torch.where(_unsigned(words) % 10 < 9, 1, 2)


def word_fresh(w1, w2, v1, v2) -> torch.Tensor:
    """Fresh two-tile boards from four rows of words."""
    p1 = word_index(w1, 16)
    q = word_index(w2, 15)
    p2 = q + (q >= p1).to(torch.int64)
    cells = torch.arange(16, device=w1.device)
    board = torch.where(cells == p1[:, None], word_tile(v1)[:, None], 0)
    return torch.where(cells == p2[:, None], word_tile(v2)[:, None], board)


def word_step(board, action, words, force_done=None):
    """One step of every lane by the kernel-word convention, with an
    automatic reset where the episode ends. ``words`` is ``(8, B)``. The
    episode ends at game over (no move changes the new board); given
    ``force_done``, where the move did not change the board and the game
    is over, or where ``force_done`` holds. Returns a dict of the board
    before the reset (``new``), after it (``final``), ``score``, ``moved``,
    ``game_over``, ``done``, ``max_exp`` and ``second_exp``."""
    merged, score, moved = pick(all_moves(board), action)
    n_empty = (merged == 0).sum(1)
    spawned = spawn_at(merged, word_index(words[2], n_empty),
                       word_tile(words[3]))
    new = torch.where(moved[:, None], spawned, board)
    over = ~legal(new).any(1)
    done = over if force_done is None else (~moved & over) | force_done
    mx, second = top_two(new)
    final = torch.where(done[:, None], word_fresh(*words[4:8]), new)
    return dict(new=new, final=final, score=score, moved=moved,
                game_over=over, done=done, max_exp=mx, second_exp=second)


def uniform_spawn(board, u_cell, u_value):
    """One tile on each board by the uniform convention."""
    n = (board == 0).sum(1).clamp_min(1)
    index = torch.minimum((u_cell * n.to(torch.float32)).to(torch.int64),
                          n - 1)
    return spawn_at(board, index, torch.where(u_value < 0.9, 1, 2))


def uniform_fresh(u: torch.Tensor) -> torch.Tensor:
    """Fresh boards from ``(4, B)`` uniforms."""
    board = torch.zeros((u.shape[1], 16), dtype=torch.int64, device=u.device)
    board = uniform_spawn(board, u[0], u[2])
    return uniform_spawn(board, u[1], u[3])


def uniform_step(board, action, u):
    """One move and, where it changed the board, one spawn from ``(2, B)``
    uniforms; no reset. Returns ``(new, score, moved, game_over)``."""
    merged, score, moved = pick(all_moves(board), action)
    new = torch.where(moved[:, None], uniform_spawn(merged, u[0], u[1]),
                      board)
    return new, score, moved, ~legal(new).any(1)


def values(exp: torch.Tensor) -> torch.Tensor:
    """Tile values of exponents (0 for an empty cell)."""
    return torch.where(exp > 0, torch.ones_like(exp) << exp, 0)
