"""Batched board operations, the port of :mod:`tpu2048.ops.board`.

Boards are ``(..., 4, 4)`` int8 exponent tensors. Actions: 0 = left,
1 = up, 2 = right, 3 = down. Arithmetic runs in int32; boards are stored as
int8.
"""

from __future__ import annotations

import torch

from tpu2048_torch.ops.rows import merge_rows_left

NUM_ACTIONS = 4
LEFT, UP, RIGHT, DOWN = 0, 1, 2, 3


def one_hot(x: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``(..., n)`` one-hot of int ``x`` (all zero outside ``[0, n)``)."""
    return (x.unsqueeze(-1) == torch.arange(n, device=x.device)).to(dtype)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 where none), int64."""
    return mask.to(torch.int8).argmax(1)


def _to_left_frame(board, action: int):
    """View ``board`` so that moving ``action`` is a left move on rows."""
    if action == LEFT:
        return board
    if action == UP:
        return board.transpose(-1, -2)
    if action == RIGHT:
        return board.flip(-1)
    if action == DOWN:
        return board.transpose(-1, -2).flip(-1)
    raise ValueError(f"invalid action {action}")


def _from_left_frame(board, action: int):
    if action == LEFT:
        return board
    if action == UP:
        return board.transpose(-1, -2)
    if action == RIGHT:
        return board.flip(-1)
    if action == DOWN:
        return board.flip(-1).transpose(-1, -2)
    raise ValueError(f"invalid action {action}")


def move(board: torch.Tensor, action: int):
    """One move (static ``action``) without a spawn.

    Returns ``(new_board, score, moved)``: the slid and merged board, the
    int32 merge score and whether the move changed the board.
    """
    merged, row_scores, row_moved = merge_rows_left(_to_left_frame(board, action))
    return (
        _from_left_frame(merged, action),
        row_scores.sum(dim=-1, dtype=torch.int32),
        row_moved.any(dim=-1),
    )


def move_all(board: torch.Tensor):
    """All four moves: ``(4, ..., 4, 4)`` int8 boards, ``(4, ...)`` int32
    scores and ``(4, ...)`` bool legality.

    The four directions' rows merge in one call on a stacked tensor, so
    that the number of ops does not grow with the directions (the classic
    env runs these as plain ops on the card, one launch each)."""
    frames = torch.stack([_to_left_frame(board, a)
                          for a in range(NUM_ACTIONS)])
    merged, row_scores, row_moved = merge_rows_left(frames)
    boards = torch.stack([_from_left_frame(merged[a], a)
                          for a in range(NUM_ACTIONS)])
    return (boards, row_scores.sum(dim=-1, dtype=torch.int32),
            row_moved.any(dim=-1))


def _action_one_hot(action: torch.Tensor) -> torch.Tensor:
    """``(4, B)`` bool; all False for an action outside ``[0, 4)``, as
    ``jax.nn.one_hot`` gives."""
    arange = torch.arange(NUM_ACTIONS, device=action.device)
    return action.unsqueeze(0) == arange.view(-1, *([1] * action.dim()))


def select_move(boards, scores, moveds, action: torch.Tensor):
    """Per-board pick of :func:`move_all`'s results by a ``(B,)`` action.

    Returns ``(board, score, moved)`` of shapes ``(B, 4, 4)``, ``(B,)``,
    ``(B,)``. An action outside ``[0, 4)`` selects an all-zero board, a zero
    score and ``moved=False``.
    """
    onehot = _action_one_hot(action)
    sel_b = (boards.to(torch.int32) * onehot[..., None, None]).sum(0)
    sel_s = (scores * onehot).sum(0, dtype=torch.int32)
    sel_m = (moveds & onehot).any(0)
    return sel_b.to(torch.int8), sel_s, sel_m


def legal_moves_mask(board: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` bool mask of the actions that change the board."""
    return move_all(board)[2].movedim(0, -1)


def is_game_over(board: torch.Tensor) -> torch.Tensor:
    """True where no action changes the board: no empty cell and no
    adjacent equal pair."""
    has_empty = (board == 0).flatten(-2).any(-1)
    h_pair = (board[..., :, :-1] == board[..., :, 1:]).flatten(-2).any(-1)
    v_pair = (board[..., :-1, :] == board[..., 1:, :]).flatten(-2).any(-1)
    return ~(has_empty | h_pair | v_pair)


def spawn_at(board: torch.Tensor, empty_idx: torch.Tensor, val: torch.Tensor):
    """Place ``val`` on the ``empty_idx``-th empty cell (row-major) of each
    board; a board with no empty cell is returned unchanged.

    Batched port of ``tpu2048.ops.board.spawn_at`` (the JAX function takes
    one board and is vmapped): ``board`` is ``(..., 4, 4)``, ``empty_idx``
    and ``val`` are ``(...,)``.
    """
    flat = board.flatten(-2)
    empty = flat == 0
    csum = empty.to(torch.int32).cumsum(-1)
    target = (csum == empty_idx.unsqueeze(-1) + 1) & empty
    new_flat = torch.where(target, val.to(flat.dtype).unsqueeze(-1), flat)
    return new_flat.view(board.shape)


def sample_spawn(board: torch.Tensor, pos_u: torch.Tensor,
                 val_u: torch.Tensor):
    """A spawn decision for each board from two ``(...,)`` float32
    uniforms in ``[0, 1)`` (batched ``tpu2048.ops.board.sample_spawn``,
    which draws them from a key).

    The index is uniform over the ``max(n_empty, 1)`` row-major empty cells
    (``floor(pos_u * n)``); the exponent is 1 (a "2") where ``val_u < 0.9``,
    else 2 (a "4"), as the reference's ``add_number`` draws them
    (Game2048_env.py:16-20). Returns ``(empty_idx, val)``: int32 and int8.
    """
    n = (board == 0).flatten(-2).sum(-1, dtype=torch.int32).clamp_min(1)
    idx = torch.minimum((pos_u * n).to(torch.int32), n - 1)
    val = torch.where(val_u < 0.9, 1, 2).to(torch.int8)
    return idx, val


def spawn_random_tile(board: torch.Tensor, pos_u: torch.Tensor,
                      val_u: torch.Tensor) -> torch.Tensor:
    """:func:`sample_spawn` then :func:`spawn_at`: a 2 (p=0.9) or a 4 on a
    uniformly drawn empty cell; a full board is returned unchanged."""
    return spawn_at(board, *sample_spawn(board, pos_u, val_u))


def init_board(pos_u: torch.Tensor, val_u: torch.Tensor) -> torch.Tensor:
    """Fresh ``(B, 4, 4)`` boards of two spawned tiles
    (Game2048_env.py:11-14): ``pos_u`` and ``val_u`` are ``(2, B)``
    uniforms, row 0 for the first tile and row 1 for the second."""
    board = torch.zeros((pos_u.shape[1], 4, 4), dtype=torch.int8,
                        device=pos_u.device)
    board = spawn_random_tile(board, pos_u[0], val_u[0])
    return spawn_random_tile(board, pos_u[1], val_u[1])


def board_values(board) -> torch.Tensor:
    """``(..., 4, 4)`` int32 face values (0 for empty cells)."""
    e = torch.as_tensor(board).to(torch.int32)
    return torch.where(e > 0, torch.ones_like(e) << e, 0)


def values_to_exponents(values) -> torch.Tensor:
    """Inverse of :func:`board_values`: face values to int8 exponents,
    ``floor(log2(v))`` read exactly off the float's exponent (the JAX
    package's float32 ``log2`` gives 14 for 32768 on the CPU)."""
    v = torch.as_tensor(values).to(torch.int32)
    exp = torch.frexp(v.clamp_min(1).to(torch.float32)).exponent - 1
    return torch.where(v > 0, exp, 0).to(torch.int8)


def max_tile_value(board: torch.Tensor) -> torch.Tensor:
    """``(...,)`` int32 value of the highest tile (0 for an empty board)."""
    e = board.flatten(-2).amax(-1).to(torch.int32)
    return torch.where(e > 0, torch.ones_like(e) << e, torch.zeros_like(e))
