"""The step kernel's design, mirrored on the CPU where the kernel cannot run.

The warp-uniform merge of ``csrc/step_kernel.cu`` gathers each row of the
chosen direction into slide-left order through ``cell(d, r, k)``, runs the
left merge, and writes the row back through ``slot(d, i)``. Both tables are
read from the source here and held against the JAX kernel's ``ROWS`` and
``_merge_all``. The rollout's quad layout (four threads a lane) is mirrored
the same way: thread t's row and column, the direction's row selected from
them, merged left, packed a byte a cell by the source's ``__byte_perm``
selectors, gathered, unpacked and written back through ``slot``; its
legality from each thread's row and column; its game over from the legal
mask. The wrappers' outputs are views of one allocation (``output_layout``,
``carve_outputs``; ``rollout_output_layout``, ``carve_rollout_outputs``);
their layouts are checked for every flag, and the launch geometry of both
rollout layouts against the source.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.ops import pallas_step as jps
from tpu2048_torch.ops import board as board_ops
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


def source_constant(name):
    match = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert match, f"no {name} in {sk.LIBRARY.source}"
    return int(match.group(1))


def test_launch_geometry_is_read_from_the_source():
    """The step kernel launches ceil(B / kThreads) blocks of kThreads
    threads; the rollout kThreads a block at kQuadThreads threads a lane
    below kQuadBatch lanes and one from it up, which rollout_geometry
    mirrors; chip_smoke.py reads kThreads from the source, not from a
    copy."""
    import chip_smoke

    threads = source_constant("kThreads")
    quad_threads = source_constant("kQuadThreads")
    quad_batch = source_constant("kQuadBatch")
    assert threads % 32 == 0 and 32 % quad_threads == 0
    assert (sk.THREADS, sk.QUAD_THREADS, sk.QUAD_BATCH) == (
        threads, quad_threads, quad_batch)
    root = sk.LIBRARY.source.parents[2]
    assert chip_smoke.source_threads(root) == threads
    flat = " ".join(SOURCE.split())
    assert "return (batch + kThreads - 1) / kThreads;" in SOURCE
    for kernel in ("step_kernel", "noop_kernel"):
        assert f"{kernel}<<<blocks_for(batch), kThreads, 0," in flat
    # Four rollout launches (Philox or bits, in each layout), all at the
    # blocks of rollout_blocks(batch, lane_threads).
    assert flat.count("<<<blocks, kThreads, 0, stream>>>(a)") == 4
    assert flat.count("rollout_quad_kernel<kShaped, kLatch,") == 2
    assert "const int blocks = rollout_blocks(batch, lane_threads);" in SOURCE
    assert ("(static_cast<long long>(batch) * lane_threads + kThreads - 1) / "
            "kThreads") in flat
    assert "const bool quad = lane_threads == kQuadThreads;" in SOURCE
    assert ("const int lane = (blockIdx.x * kThreads + threadIdx.x) / "
            "kQuadThreads;") in flat
    for b in (1, 3, 511, 512, 1000, 4096, quad_batch - 1, quad_batch,
              quad_batch + 1, 65536):
        lane_threads = quad_threads if b < quad_batch else 1
        blocks = (b * lane_threads + threads - 1) // threads
        assert sk.rollout_geometry(b) == (lane_threads, blocks)
        assert blocks * threads >= b * lane_threads > (blocks - 1) * threads


# The quad layout, mirrored with int64 torch ops on (B,) lanes.

def by_dir(d, *values):
    """``by_dir``: the one of four values that d (a tensor) picks."""
    return torch.where(d == 0, values[0], torch.where(
        d == 1, values[1], torch.where(d == 2, values[2], values[3])))


def own_lines(c, t):
    """``own_lines``: row t and column t of each (16, B) board."""
    tt = torch.full_like(c[0], t)
    h = [by_dir(tt, *[c[cell(0, r, k)] for r in range(4)]) for k in range(4)]
    v = [by_dir(tt, *[c[cell(1, r, k)] for r in range(4)]) for k in range(4)]
    return h, v


def source_byte_perm_selectors():
    """The three selectors of ``pack_bytes``' ``__byte_perm`` calls."""
    match = re.search(
        r"__byte_perm\(__byte_perm\(x0, x1, (0x[0-9A-Fa-f]+)\),\s*"
        r"__byte_perm\(x2, x3, (0x[0-9A-Fa-f]+)\), (0x[0-9A-Fa-f]+)\)",
        SOURCE)
    assert match, "pack_bytes not found"
    return [int(g, 16) for g in match.groups()]


def byte_perm(x, y, s):
    """PTX ``prmt`` in its default mode: byte i of the result is byte
    (nibble i of s) & 7 of the eight bytes of (y, x), or that byte's sign
    spread where the nibble's top bit is set."""
    out = torch.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 0xF
        src = x if (sel & 7) < 4 else y
        byte = (src >> (8 * (sel & 3))) & 0xFF
        if sel & 8:
            byte = torch.where(byte >= 0x80, 0xFF, 0)
        out = out | (byte << (8 * i))
    return out


def byte_at(word, k):
    """``byte_at``: byte k of a word as a signed 8-bit value."""
    byte = (word >> (8 * k)) & 0xFF
    return byte - ((byte & 0x80) << 1)


def test_row_of_direction_comes_from_the_own_lines():
    """Row r of direction d is h[k], v[k], h[3 - k], v[3 - k] of thread r's
    lines: the source's selects agree with the cell table."""
    flat = " ".join(SOURCE.split())
    assert "x[k] = by_dir(d, h[k], v[k], h[3 - k], v[3 - k]);" in flat
    assert ("h[k] = by_dir(t, c[cell(0, 0, k)], c[cell(0, 1, k)], "
            "c[cell(0, 2, k)], c[cell(0, 3, k)]);") in flat
    assert ("v[k] = by_dir(t, c[cell(1, 0, k)], c[cell(1, 1, k)], "
            "c[cell(1, 2, k)], c[cell(1, 3, k)]);") in flat
    for d, t, k in itertools.product(range(4), range(4), range(4)):
        h = [cell(0, t, j) for j in range(4)]
        v = [cell(1, t, j) for j in range(4)]
        assert [h[k], v[k], h[3 - k], v[3 - k]][d] == cell(d, t, k)


@pytest.mark.parametrize("d", range(4))
def test_quad_merge_pack_gather_unpack_is_merge_all(d):
    """Each thread t of a quad selects row t of direction d from its own
    row and column, merges it left and packs it into one word; the quad
    gathers the four words, and each thread unpacks them and writes the
    board back through slot: the board and score of JAX's all-direction
    merge for direction d, in every thread."""
    boards = seeded_boards(60 + d)
    b = len(boards)
    c = torch.from_numpy(boards.T.astype(np.int64))  # (16, b), as int32 regs
    dd = torch.full((b,), d, dtype=torch.int64)
    s0, s1, s2 = source_byte_perm_selectors()
    words, score = [], 0
    for t in range(4):
        h, v = own_lines(c, t)
        x = torch.stack([by_dir(dd, h[k], v[k], h[3 - k], v[3 - k])
                         for k in range(4)], -1)  # (b, 4)
        merged, row_score, _ = rows_ops.merge_rows_left(
            x.to(torch.int8).view(b, 1, 4))
        y = merged.view(b, 4).to(torch.int64)
        words.append(byte_perm(byte_perm(y[:, 0], y[:, 1], s0),
                               byte_perm(y[:, 2], y[:, 3], s1), s2))
        score = score + row_score.view(b).to(torch.int64)
    ys = [byte_at(words[r], k) for r in range(4) for k in range(4)]
    got = torch.stack([by_dir(dd, *[ys[slot(e, i)] for e in range(4)])
                       for i in range(16)], -1).numpy()

    cells = [jnp.asarray(boards[:, j].astype(np.int32))[None]
             for j in range(16)]
    ys_j, score_d, _ = jps._merge_all(cells)
    ys_j = np.stack([np.asarray(y) for y in ys_j])
    want = np.stack([ys_j[jps.REASM[(d, j)][1], jps.REASM[(d, j)][0]]
                     for j in range(16)], axis=-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(score.numpy(), np.asarray(score_d[d])[0])
    assert (got != boards).any() and score.any()


def line_moves(a):
    """``line_moves``: bit 0 if the line moves toward a[0], bit 1 toward
    a[3]."""
    n = [x != 0 for x in a]
    pair = ((a[0] == a[1]) & n[0]) | ((a[1] == a[2]) & n[1]) | (
        (a[2] == a[3]) & n[2])
    hole0 = (~n[0] & (n[1] | n[2] | n[3])) | (~n[1] & (n[2] | n[3])) | (
        ~n[2] & n[3])
    hole3 = (~n[3] & (n[2] | n[1] | n[0])) | (~n[2] & (n[1] | n[0])) | (
        ~n[1] & n[0])
    return (hole0 | pair).long() | ((hole3 | pair).long() << 1)


def quad_legal(c):
    """``quad_legal``: each thread's mask from its row and column, ORed
    over the quad; bit d is direction d."""
    m = 0
    for t in range(4):
        h, v = own_lines(c, t)
        mh, mv = line_moves(h), line_moves(v)
        m = m | (mh & 1) | (mv & 1) << 1 | (mh & 2) << 1 | (mv & 2) << 2
    return m


def legal_and_game_over_boards():
    boards = seeded_boards(70)
    checker = np.where((np.arange(4)[:, None] + np.arange(4)) % 2 == 0, 1, 2)
    boards[:8] = checker.reshape(16)  # game over
    boards[8:16] = 0  # empty: no legal direction, not game over
    boards[16:24] = checker.reshape(16)
    boards[16:24, 5] = 0  # one hole
    return boards


def test_quad_legal_mask_is_legal_moves_mask():
    boards = legal_and_game_over_boards()
    m = quad_legal(torch.from_numpy(boards.T.astype(np.int64)))
    got = ((m.unsqueeze(-1) >> torch.arange(4)) & 1).bool()
    want = board_ops.legal_moves_mask(
        torch.from_numpy(boards).view(-1, 4, 4))
    assert torch.equal(got, want)
    assert want.any(-1).any() and not want.any(-1).all()


def test_game_over_is_no_legal_direction_on_a_board_with_a_tile():
    """quad_env_step's game over: no legal direction and a tile (the empty
    board has neither a legal direction nor game over)."""
    assert "s.game_over = legal == 0 && tile;" in SOURCE
    boards = legal_and_game_over_boards()
    c = torch.from_numpy(boards.T.astype(np.int64))
    got = (quad_legal(c) == 0) & (c != 0).any(0)
    want = board_ops.is_game_over(torch.from_numpy(boards).view(-1, 4, 4))
    assert torch.equal(got, want)
    assert want.any() and not want.all()


def test_quad_maxima_are_max_and_second():
    """quad_env_step's maxima: each thread's row max, count of the max and
    largest cell below it, reduced over the quad, give the plain step's
    max and second exponents (second skips only the first max cell)."""
    assert "s.second = cnt >= 2 ? max(mx, 0) : below;" in SOURCE
    boards = legal_and_game_over_boards()
    boards[24:32] = 0
    boards[24:32, 3] = boards[24:32, 12] = 9  # two equal maxima
    boards[32:40] = 0
    boards[32:40, 7] = 5  # one tile
    c = torch.from_numpy(boards.T.astype(np.int64))
    rows = [torch.stack(own_lines(c, t)[0], -1) for t in range(4)]  # (b, 4)
    mx = torch.stack([r.amax(-1) for r in rows], -1).amax(-1)
    cnt = sum((r == mx[:, None]).sum(-1) for r in rows)
    below = torch.stack([torch.where(r < mx[:, None], r, 0).amax(-1)
                         for r in rows], -1).amax(-1).clamp_min(0)
    second = torch.where(cnt >= 2, mx.clamp_min(0), below)

    b = len(boards)
    # Action 4 leaves the board as it was: its maxima are the step's.
    plain = sk.plain_env_step(
        torch.from_numpy(boards.T.copy()),
        torch.full((b,), 4, dtype=torch.int32),
        torch.zeros((8, b), dtype=torch.int32))
    assert torch.equal(mx, plain[4].long()) and torch.equal(
        second, plain[5].long())
    assert (plain[4] == plain[5]).any() and (plain[4] != plain[5]).any()


LATCH_STALL = list(itertools.product((False, True), repeat=2))


@pytest.mark.parametrize("latch,shaped", LATCH_STALL)
@pytest.mark.parametrize("b", [1, 3, 512])
def test_carved_rollout_outputs_are_disjoint_views(b, latch, shaped):
    n, words, cells, offsets = sk.rollout_output_layout(b, latch, shaped)
    buf = torch.empty(n, dtype=torch.int8)
    outs = [t for o in sk.carve_rollout_outputs(buf, b, latch, shaped)
            for t in (o if isinstance(o, tuple) else (o,))]
    assert len(offsets) == 13 and len(words) + len(cells) == (
        6 + 2 * shaped + 5 * latch)
    words = sum(words) // b  # 32-bit rows of b
    assert words == 5 + 2 * shaped + 6 * latch
    # The C entry's order: boards, score, steps, return, reward_sum,
    # done_count, consec_action, consec_count, latched, fscore, fsteps,
    # fmax, acnt; the views' order: the same, the latches before the
    # stall lanes.
    present = [offsets[:6], offsets[8:] if latch else (),
               offsets[6:8] if shaped else ()]
    present = [o for part in present for o in part]
    assert None not in present and offsets.count(None) == (
        13 - len(present))
    assert len(outs) == len(present)
    spans = []
    for t, offset in zip(outs, present):
        assert t.is_contiguous()
        assert (t.untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr())
        start = t.data_ptr() - buf.data_ptr()
        assert start == offset
        spans.append((start, start + t.numel() * t.element_size()))
    # Every 32-bit output lies before the int8 ones, from the start.
    wide = [t for t in outs if t.element_size() == 4]
    assert max(t.data_ptr() for t in wide) - buf.data_ptr() < 4 * words * b
    assert outs[1].data_ptr() == buf.data_ptr()
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end == start  # no overlap, no gap


@pytest.mark.parametrize("latch,shaped", LATCH_STALL)
def test_carved_rollout_outputs_follow_the_rollout_contract(latch, shaped):
    """The views have the types and shapes of the plain rollout's outputs,
    in the same order and nesting."""
    b, k = 8, 2
    rng = np.random.default_rng(9)

    def ints(lo, hi, shape=(b,), dtype=np.int32):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype))

    lanes = (ints(0, 5, (16, b), np.int8), ints(0, 9), ints(0, 9),
             ints(0, 9).to(torch.float32))
    latch_state = ((ints(0, 2, dtype=np.int8), ints(0, 9), ints(0, 9),
                    ints(0, 9, dtype=np.int8), ints(0, 9, (4, b)))
                   if latch else None)
    stall_state = (ints(-1, 4), ints(0, 3)) if shaped else None
    plain = sk.plain_env_rollout(*lanes, k, None, latch_state, stall_state,
                                 seed=5, step=0)
    carved = sk.carve_rollout_outputs(
        torch.empty(sk.rollout_output_layout(b, latch, shaped)[0],
                    dtype=torch.int8), b, latch, shaped)

    def kinds(outs):
        return [tuple((t.shape, t.dtype) for t in o) if isinstance(o, tuple)
                else (o.shape, o.dtype) for o in outs]

    assert kinds(carved) == kinds(plain)
