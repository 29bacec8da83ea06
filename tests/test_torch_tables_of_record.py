"""The committed Q-tables of record, read by both packages on the CPU.

``runs/tabular_200k_r5/qtable.npz`` (the packed trainer's 200k-game run, in
the bucketed layout) is read by each package's ``load_qtable``;
``runs/tabular_200k/qtable.npz`` (an older run, in the linear layout) goes
through each package's ``rehash_table``. The tables must be equal word for
word, packed and unpacked, and agree with their run's last metrics row.
Then on a seeded sample of the stored keys, decoded to boards, and on the
boards of a short seeded greedy play, the Q rows of ``qtable_lookup`` and
of ``fast_lookup`` (JAX's ``xla`` backend) and the greedy actions must be
equal bit for bit. A table the port loads and saves must load in JAX's
``load_qtable`` with equal arrays.

Each table is 2**25 slots (800 MB unpacked, 1 GiB packed a package); a
module-scoped fixture loads one at a time. A missing file skips its cases.
"""

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.agents import tabular as jtab
from tpu2048.agents import tabular_fast as jtabf
from tpu2048.eval.evaluate import greedy_tabular_policy as j_greedy_policy
from tpu2048.ops.board import legal_moves_mask as j_legal
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.agents import tabular_fast as ttabf
from tpu2048_torch.env.fast import (FastEnvConfig, GeneratorBits, fast_reset,
                                    fast_step)
from tpu2048_torch.eval.evaluate import greedy_tabular_policy
from tpu2048_torch.ops.board import legal_moves_mask
from tpu2048_torch.ops.step_kernel import from_cell_major

REPO = Path(__file__).resolve().parents[1]
RUNS = {"bucketed": "runs/tabular_200k_r5", "linear": "runs/tabular_200k"}
SEED = 2048
STORED_SAMPLE = 4096
PLAY_LANES, PLAY_STEPS = 64, 96
# The round trip writes the first 2**21 slots: save and load copy arrays
# whatever their layout, and compressing all 2**25 takes ~40 s on one core.
ROUND_TRIP_SLOTS = 1 << 21

j_pack = jax.jit(jtabf.pack_qtable)
j_rehash = jax.jit(jtab.rehash_table)
j_lookup = jax.jit(jtab.qtable_lookup)
j_fast_lookup = jax.jit(jtabf.fast_lookup, static_argnums=2)


@jax.jit
def j_greedy(table, boards, legal):
    return j_greedy_policy(table).fn(table, boards, legal, None)


def u32(t):
    return t.numpy().view(np.uint32)


def assert_words_equal(got, want):
    """Whole-table arrays, compared without ``assert_array_equal``'s
    report, which takes seconds for 1 GiB."""
    assert got.shape == want.shape and np.array_equal(got, want)


def last_row(run):
    with open(REPO / run / "metrics.jsonl") as f:
        return json.loads(f.read().splitlines()[-1])


def read_linear(path):
    """The file's arrays as each package's two-array table, before any
    rehash."""
    with np.load(path) as z:
        assert "layout" not in z.files  # the linear layout
        words = {k: np.ascontiguousarray(z[k]) for k in ("key_lo", "key_hi")}
        q = np.asarray(z["q"], np.float32)
        dropped = int(z["dropped"])
    jt = jtab.QTable(key_lo=jnp.asarray(words["key_lo"]),
                     key_hi=jnp.asarray(words["key_hi"]), q=jnp.asarray(q),
                     dropped=jnp.asarray(dropped, jnp.int32))
    tt = ttab.QTable(
        key_lo=torch.from_numpy(words["key_lo"].view(np.int32)),
        key_hi=torch.from_numpy(words["key_hi"].view(np.int32)),
        q=torch.from_numpy(q), dropped=torch.tensor(dropped,
                                                    dtype=torch.int32))
    return jt, tt


@pytest.fixture(scope="module", params=sorted(RUNS))
def tables(request):
    run = RUNS[request.param]
    path = REPO / run / "qtable.npz"
    if not path.is_file():
        pytest.skip(f"{run}/qtable.npz is not in this checkout")
    if request.param == "bucketed":
        jt, tt = jtab.load_qtable(str(path)), ttab.load_qtable(str(path))
    else:
        jt, tt = read_linear(path)
        jt, tt = j_rehash(jt), ttab.rehash_table(tt)
    policy = greedy_tabular_policy(tt)  # the port's packed table
    return types.SimpleNamespace(kind=request.param, run=run, path=path,
                                jt=jt, jp=j_pack(jt), tt=tt, policy=policy)


def decode(lo, hi):
    """Key words -> ``(n, 4, 4)`` int8 exponent boards (``pack_board``'s
    inverse)."""
    shifts = np.arange(8, dtype=np.uint32) * 4
    cells = [(w[:, None] >> shifts) & 15 for w in (lo, hi)]
    return np.concatenate(cells, axis=1).astype(np.int8).reshape(-1, 4, 4)


def stored_boards(t):
    """Boards of a seeded sample of the table's stored keys."""
    occupied = np.flatnonzero(t.tt.occupied.numpy())
    rng = np.random.default_rng(SEED)
    slots = rng.choice(occupied, STORED_SAMPLE, replace=False)
    return decode(u32(t.tt.key_lo)[slots], u32(t.tt.key_hi)[slots])


def played_boards(t):
    """Every board of a short greedy play of the port's table on the CPU
    (simple env, generator bits from SEED), before each step."""
    bits = GeneratorBits(SEED, torch.device("cpu"))
    config = FastEnvConfig()
    state = fast_reset(bits, PLAY_LANES, config)
    boards = []
    for _ in range(PLAY_STEPS):
        board = from_cell_major(state.boards)
        boards.append(board.numpy())
        actions = t.policy(board, state.legal)
        state, _ = fast_step(config, state, bits, actions, need_legal=True)
    return np.concatenate(boards)


BOARDS = {"stored": stored_boards, "played": played_boards}


def test_both_packages_read_the_same_table(tables):
    """Keys, Q words, ``dropped`` and the packed image equal; the table is
    its run's: its keys are the last row's ``q_states`` (less the entries
    the rehash dropped, which ``dropped`` counts), its drops the row's."""
    jt, tt = tables.jt, tables.tt
    assert_words_equal(u32(tt.key_lo), np.asarray(jt.key_lo))
    assert_words_equal(u32(tt.key_hi), np.asarray(jt.key_hi))
    assert_words_equal(u32(tt.q.view(torch.int32)),
                       np.asarray(jt.q).view(np.uint32))
    assert int(tt.dropped) == int(jt.dropped)
    assert_words_equal(u32(tables.policy.params.data),
                       np.asarray(tables.jp.data))
    row = last_row(tables.run)
    occupied = int(tt.occupied.sum())
    rehash_drops = int(tt.dropped) - row["dropped_updates"]
    assert occupied + rehash_drops == row["q_states"]
    assert rehash_drops == 0 if tables.kind == "bucketed" else rehash_drops > 0


@pytest.mark.parametrize("source", sorted(BOARDS))
def test_lookups_and_greedy_actions_agree(tables, source):
    boards = BOARDS[source](tables)
    tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
    want = np.asarray(j_lookup(tables.jt, jb)).view(np.uint32)
    np.testing.assert_array_equal(
        u32(ttab.qtable_lookup(tables.tt, tb).view(torch.int32)), want)
    np.testing.assert_array_equal(
        u32(ttabf.fast_lookup(tables.policy.params, tb).view(torch.int32)),
        want)
    np.testing.assert_array_equal(
        np.asarray(j_fast_lookup(tables.jp, jb, "xla")).view(np.uint32),
        want)
    legal = legal_moves_mask(tb)
    np.testing.assert_array_equal(legal.numpy(), np.asarray(j_legal(jb)))
    np.testing.assert_array_equal(
        tables.policy(tb, legal).numpy(),
        np.asarray(j_greedy(tables.jt, jb, jnp.asarray(legal.numpy()))))
    # The boards read learned values, not only the zeros of unseen states.
    assert (want != 0).any(-1).mean() > 0.25


@pytest.mark.parametrize("tables", ["bucketed"], indirect=True)
def test_a_table_the_port_saves_loads_in_jax(tables, tmp_path):
    tt = tables.tt
    part = ttab.QTable(key_lo=tt.key_lo[:ROUND_TRIP_SLOTS],
                       key_hi=tt.key_hi[:ROUND_TRIP_SLOTS],
                       q=tt.q[:ROUND_TRIP_SLOTS], dropped=tt.dropped)
    path = str(tmp_path / "qtable.npz")
    ttab.save_qtable(path, part)
    jt = jtab.load_qtable(path)
    assert_words_equal(np.asarray(jt.key_lo), u32(part.key_lo))
    assert_words_equal(np.asarray(jt.key_hi), u32(part.key_hi))
    assert_words_equal(np.asarray(jt.q).view(np.uint32),
                       u32(part.q.view(torch.int32)))
    assert int(jt.dropped) == int(part.dropped)
    assert int(part.occupied.sum()) > 0
