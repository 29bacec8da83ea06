"""The step kernel's design, mirrored on the CPU where the kernel cannot run.

The warp-uniform merge of ``csrc/step_kernel.cu`` gathers each row of the
chosen direction into slide-left order through ``cell(d, r, k)``, runs the
left merge, and writes the row back through ``slot(d, i)``. Both tables are
read from the source here and held against the JAX kernel's ``ROWS`` and
``_merge_all``. The wrapper's outputs are views of one allocation
(``output_layout``, ``carve_outputs``); their layout is checked for every
emit flag, and the launch geometry against the source.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.ops import pallas_step as jps
from tpu2048_torch.ops import rows as rows_ops
from tpu2048_torch.ops import step_kernel as sk

SOURCE = sk.LIBRARY.source.read_text()


def source_table(name, args):
    """The constexpr function ``name`` of the source, a chain of
    ``d == 0 ? e0 : d == 1 ? e1 : d == 2 ? e2 : e3`` over int arguments,
    as a Python function (C's ``/`` on non-negative ints is ``//``)."""
    match = re.search(
        rf"constexpr int {name}\({', '.join(f'int {a}' for a in args)}\) "
        r"\{\s*return d == 0 \? (.+?)\s*: d == 1 \? (.+?)\s*"
        r": d == 2 \? (.+?)\s*: (.+?);\s*\}", SOURCE, re.S)
    assert match, f"{name} not found in {sk.LIBRARY.source}"
    exprs = [e.replace(" / ", " // ") for e in match.groups()]

    def table(*values):
        env = dict(zip(args, values))
        return eval(exprs[env["d"]], {}, env)  # noqa: S307 - source text

    return table


cell = source_table("cell", ("d", "r", "k"))
slot = source_table("slot", ("d", "i"))


def test_merge_reads_and_writes_through_the_tables():
    """merge_dir gathers by cell() and writes back by slot(), picking the
    direction with by_dir's selects."""
    assert re.search(
        r"return d == 0 \? v0 : d == 1 \? v1 : d == 2 \? v2 : v3;", SOURCE)
    flat = " ".join(SOURCE.split())
    assert ("by_dir(d, c[cell(0, r, k)], c[cell(1, r, k)], c[cell(2, r, k)], "
            "c[cell(3, r, k)])") in flat
    assert ("by_dir(d, y[slot(0, i)], y[slot(1, i)], y[slot(2, i)], "
            "y[slot(3, i)])") in flat


@pytest.mark.parametrize("d", range(4))
def test_cell_table_is_jax_rows(d):
    assert [[cell(d, r, k) for k in range(4)] for r in range(4)] == jps.ROWS[d]


@pytest.mark.parametrize("d", range(4))
def test_slot_inverts_cell(d):
    for r, k in itertools.product(range(4), range(4)):
        assert slot(d, cell(d, r, k)) == 4 * r + k
    assert sorted(slot(d, i) for i in range(16)) == list(range(16))


def seeded_boards(seed, b=512):
    """(b, 16) int8 boards: sparse, dense, full and with equal runs."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(1, 11, (b, 16))
    boards[rng.random((b, 16)) < 0.35] = 0
    boards[: b // 8] = rng.integers(1, 3, (b // 8, 16))  # many pairs
    boards[b // 8: b // 4] = 0  # empty and near-empty
    boards[b // 8: b // 4, 5] = 4
    return boards.astype(np.int8)


@pytest.mark.parametrize("d", range(4))
def test_gather_merge_left_scatter_is_merge_all(d):
    """Gather to slide-left order, merge left, scatter back: the board and
    score of JAX's all-direction merge for direction d."""
    boards = seeded_boards(40 + d)
    b = len(boards)
    gather = [[cell(d, r, k) for k in range(4)] for r in range(4)]
    rows = torch.from_numpy(boards[:, np.array(gather)])  # (b, 4, 4)
    merged, row_scores, _ = rows_ops.merge_rows_left(rows)
    flat = merged.reshape(b, 16)
    got = flat[:, [slot(d, i) for i in range(16)]].numpy()
    got_score = row_scores.sum(-1).numpy()

    cells = [jnp.asarray(boards[:, j].astype(np.int32))[None]
             for j in range(16)]
    ys, score_d, _ = jps._merge_all(cells)
    ys = np.stack([np.asarray(y) for y in ys])  # (lane position, row, b)
    want = np.stack([ys[jps.REASM[(d, j)][1], jps.REASM[(d, j)][0]]
                     for j in range(16)], axis=-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_score, np.asarray(score_d[d])[0])
    assert (got != boards).any() and got_score.any()


FLAGS = list(itertools.product((False, True), repeat=3))


@pytest.mark.parametrize("shaped,pre,legal", FLAGS)
@pytest.mark.parametrize("b", [1, 3, 512])
def test_carved_outputs_are_disjoint_views(b, shaped, pre, legal):
    n, _, offsets = sk.output_layout(b, shaped, pre, legal)
    buf = torch.empty(n, dtype=torch.int8)
    outs = sk.carve_outputs(buf, b, shaped, pre, legal)
    assert len(offsets) == 9
    want = [((16, b), torch.int8), ((b,), torch.int32), ((b,), torch.bool),
            ((b,), torch.bool), ((b,), torch.int8), ((b,), torch.int8),
            ((b,), torch.bool) if shaped else None,
            ((16, b), torch.int8) if pre else None,
            ((4, b), torch.int8) if legal else None]
    assert [w is None for w in want] == [o is None for o in offsets]
    want = [w for w in want if w is not None]
    offsets = [o for o in offsets if o is not None]
    assert len(outs) == len(want) == len(offsets)
    spans = []
    for t, w, offset in zip(outs, want, offsets):
        assert (tuple(t.shape), t.dtype) == w
        assert t.is_contiguous()
        assert (t.untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr())
        # The pointer the wrapper hands the C entry is the view's own.
        start = t.data_ptr() - buf.data_ptr()
        assert start == offset
        spans.append((start, start + t.numel() * t.element_size()))
    # The int32 score sits at the buffer's start, so at its alignment.
    assert offsets[1] == 0 and outs[1].dtype == torch.int32
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end == start  # no overlap, no gap


@pytest.mark.parametrize("shaped,pre,legal", FLAGS)
def test_carved_outputs_follow_the_step_contract(shaped, pre, legal):
    """The views have the types and shapes of the plain step's outputs, in
    the same order."""
    b = 8
    rng = np.random.default_rng(7)
    boards = torch.from_numpy(rng.integers(0, 5, (16, b)).astype(np.int8))
    actions = torch.from_numpy(rng.integers(-1, 4, b).astype(np.int32))
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, (8, b), np.int32))
    force_done = torch.zeros(b, dtype=torch.bool) if shaped else None
    plain = sk.plain_env_step(boards, actions, bits, force_done,
                              emit_pre_reset=pre, emit_legal=legal)
    carved = sk.carve_outputs(
        torch.empty(sk.output_layout(b, shaped, pre, legal)[0],
                    dtype=torch.int8), b, shaped, pre, legal)
    assert [(t.shape, t.dtype) for t in carved] == [
        (t.shape, t.dtype) for t in plain]


def test_launch_geometry_is_read_from_the_source():
    """Both kernels launch ceil(B / kThreads) blocks of kThreads threads,
    and chip_smoke.py reads kThreads from the source, not from a copy."""
    import chip_smoke

    match = re.search(r"constexpr int kThreads = (\d+);", SOURCE)
    assert match and int(match.group(1)) % 32 == 0
    root = sk.LIBRARY.source.parents[2]
    assert chip_smoke.source_threads(root) == int(match.group(1))
    assert "return (batch + kThreads - 1) / kThreads;" in SOURCE
    flat = " ".join(SOURCE.split())
    for kernel in ("step_kernel", "noop_kernel"):
        assert f"{kernel}<<<blocks_for(batch), kThreads, 0," in flat
    assert flat.count("<<<blocks, kThreads, 0, stream>>>(a)") == 2
    assert "const int blocks = blocks_for(batch);" in SOURCE
