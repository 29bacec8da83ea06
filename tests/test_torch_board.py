"""Board ops of the PyTorch port against ``tpu2048.ops`` on the same boards.

Inputs are made with numpy from a seed and given to both packages; every
result is an integer or bool array and must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_engine import ROW_CASES

from tpu2048.ops import board as jboard
from tpu2048.ops import rows as jrows
from tpu2048_torch.ops import board as tboard
from tpu2048_torch.ops import rows as trows


def random_boards(seed, n=512, high=12):
    """Exponent boards with ~35% empty cells and some 15s (the top tile)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(1, high, (n, 4, 4))
    b[rng.random((n, 4, 4)) < 0.35] = 0
    b[rng.random((n, 4, 4)) < 0.02] = 15
    return b.astype(np.int8)


def same(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))
    assert torch_out.numpy().dtype == np.asarray(jax_out).dtype


def exps(values):
    v = np.asarray(values)
    return np.where(v > 0, np.log2(np.maximum(v, 1)), 0).astype(np.int8)


@pytest.mark.parametrize("row,expected,score,moved", ROW_CASES)
def test_merge_row_golden(row, expected, score, moved):
    rows = exps(row)
    new, s, m = trows.merge_rows_left(torch.from_numpy(rows))
    jnew, js, jm = jrows.merge_rows_left(jnp.asarray(rows))
    same(new, jnew)
    same(s, js)
    same(m, jm)
    np.testing.assert_array_equal(new.numpy(), exps(expected))
    assert int(s) == score and bool(m) == moved


def test_merge_rows_random():
    rows = random_boards(0).reshape(-1, 4)
    for t, j in zip(trows.merge_rows_left(torch.from_numpy(rows)),
                    jrows.merge_rows_left(jnp.asarray(rows))):
        same(t, j)


@pytest.mark.parametrize("action", range(4))
def test_move(action):
    boards = random_boards(1 + action)
    for t, j in zip(tboard.move(torch.from_numpy(boards), action),
                    jboard.move(jnp.asarray(boards), action)):
        same(t, j)


def test_move_all_select_move_and_legality():
    boards = random_boards(5)
    actions = np.random.default_rng(6).integers(0, 4, len(boards))
    actions = actions.astype(np.int32)
    tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
    t_all, j_all = tboard.move_all(tb), jboard.move_all(jb)
    for t, j in zip(t_all, j_all):
        same(t, j)
    for t, j in zip(tboard.select_move(*t_all, torch.from_numpy(actions)),
                    jboard.select_move(*j_all, jnp.asarray(actions))):
        same(t, j)
    same(tboard.legal_moves_mask(tb), jboard.legal_moves_mask(jb))
    same(tboard.is_game_over(tb), jboard.is_game_over(jb))
    same(tboard.max_tile_value(tb), jboard.max_tile_value(jb))


def test_select_move_out_of_range_action_is_a_no_op():
    boards = random_boards(7, n=8)
    actions = np.array([4, 7, 0, 1, 2, 3, 4, 5], np.int32)
    t = tboard.select_move(*tboard.move_all(torch.from_numpy(boards)),
                           torch.from_numpy(actions))
    j = jboard.select_move(*jboard.move_all(jnp.asarray(boards)),
                           jnp.asarray(actions))
    for a, b in zip(t, j):
        same(a, b)


# The game-over truth table of tests/test_engine.py::test_game_over_cases,
# plus a full board with a 2048 pair.
GAME_OVER_BOARDS = [
    [[2, 4, 2, 4], [4, 2, 4, 2], [2, 4, 2, 4], [4, 2, 4, 0]],
    [[2, 4, 2, 4], [4, 2, 4, 2], [2, 4, 2, 4], [4, 2, 4, 2]],
    [[2, 2, 8, 4], [4, 8, 4, 2], [2, 4, 2, 4], [4, 2, 4, 2]],
    [[2, 4, 2, 4], [2, 8, 4, 2], [4, 2, 8, 4], [8, 4, 2, 8]],
    [[2048, 2048, 8, 4], [4, 8, 4, 2], [2, 4, 2, 4], [4, 2, 4, 2]],
]


@pytest.mark.parametrize("values", GAME_OVER_BOARDS)
def test_game_over_cases(values):
    board = exps(values)
    tb, jb = torch.from_numpy(board), jnp.asarray(board)
    same(tboard.is_game_over(tb), jboard.is_game_over(jb))
    same(tboard.legal_moves_mask(tb), jboard.legal_moves_mask(jb))


def test_spawn_at():
    boards = random_boards(8)
    boards[:4] = 0  # empty boards
    boards[4:8] = 3  # full boards: spawn is a no-op
    rng = np.random.default_rng(9)
    n_empty = (boards == 0).reshape(len(boards), 16).sum(-1)
    idx = (rng.integers(0, 1 << 16, len(boards)) % np.maximum(n_empty, 1))
    idx = idx.astype(np.int32)
    val = rng.integers(1, 3, len(boards)).astype(np.int8)
    got = tboard.spawn_at(torch.from_numpy(boards), torch.from_numpy(idx),
                          torch.from_numpy(val))
    same(got, jax.vmap(jboard.spawn_at)(jnp.asarray(boards), jnp.asarray(idx),
                                        jnp.asarray(val)))
