"""The table kernels' plain versions against the JAX package's ``_xla``
twins (which tests/test_tabular_fast.py holds bit-exact to the Pallas
kernels), on random tables whose words include the top bit.

The scatter's equality covers rows ``[0, NB)`` only: several entries write
the trash row ``NB`` and may land in any order, and nothing reads it.
"""

import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.ops import table_kernel as jtk
from tpu2048_torch.ops import table_kernel as ttk

NB = 32  # buckets


def random_words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def test_layout_constants_match():
    assert (ttk.BUCKET, ttk.WIDTH, ttk.ROW) == (jtk.BUCKET, jtk.WIDTH,
                                                jtk.ROW)


@pytest.mark.parametrize("n", [1, 5, 33])
def test_plain_versions_match_the_xla_twins(n):
    rng = np.random.default_rng(n)
    data = random_words(rng, (NB + 1, ttk.ROW))
    buckets = rng.integers(0, NB, n, dtype=np.int32)
    buckets[0] = NB - 1
    t_data = torch.from_numpy(data.view(np.int32).copy())

    before = ttk.bucket_gather.launches
    got = ttk.bucket_gather(t_data, torch.from_numpy(buckets))
    assert ttk.bucket_gather.launches == before  # CPU: the plain version
    want = jtk.bucket_gather_xla(jnp.asarray(data), jnp.asarray(buckets))
    assert got.shape == (n, ttk.BUCKET, ttk.WIDTH) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))

    ids = np.concatenate([rng.choice(NB, n - n // 2, replace=False),
                          np.full(n // 2, NB)]).astype(np.int32)
    rows = random_words(rng, (n, ttk.BUCKET, ttk.WIDTH))
    ptr = t_data.data_ptr()
    before = ttk.bucket_scatter_.launches
    out = ttk.bucket_scatter_(t_data, torch.from_numpy(ids),
                              torch.from_numpy(rows.view(np.int32)))
    assert ttk.bucket_scatter_.launches == before
    want = jtk.bucket_scatter_xla(jnp.asarray(data), jnp.asarray(ids),
                                  jnp.asarray(rows))
    assert out is t_data and t_data.data_ptr() == ptr  # in place
    np.testing.assert_array_equal(t_data.numpy()[:-1].view(np.uint32),
                                  np.asarray(want)[:-1])
    untouched = np.setdiff1d(np.arange(NB), ids)
    np.testing.assert_array_equal(t_data.numpy()[untouched],
                                  data.view(np.int32)[untouched])


def test_wrappers_check_their_inputs():
    data = torch.zeros((NB + 1, ttk.ROW), dtype=torch.int32)
    ok = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="data"):
        ttk.bucket_gather(data[:, :64], ok)
    with pytest.raises(ValueError, match="buckets"):
        ttk.bucket_gather(data, ok.long())
    with pytest.raises(ValueError, match="empty"):
        ttk.bucket_gather(data, ok[:0])
    with pytest.raises(ValueError, match="rows"):
        ttk.bucket_scatter_(data, ok, torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        ttk.bucket_gather(data.to("meta"), ok.to("meta"))


SOURCE = ttk.LIBRARY.source.read_text()


def source_constant(name):
    match = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert match, f"{name} not found in {ttk.LIBRARY.source}"
    return int(match.group(1))


def test_launch_geometry_mirrors_the_source():
    assert source_constant("kWarps") == ttk.WARPS
    assert "kThreads = 32 * kWarps" in SOURCE
    assert source_constant("kRows") == ttk.STAGE_ROWS
    assert source_constant("kStages") == ttk.RING_STAGES
    assert source_constant("kMaxBlocks") == ttk.MAX_BLOCKS
    assert source_constant("kRowWords") == ttk.ROW
    assert "kSharedBytes = kWarps * kStages * (kStageBytes + 8)" in SOURCE
    g = ttk.launch_geometry(1)
    assert (g.warps, g.stages, g.rows_per_stage) == (
        ttk.WARPS, ttk.RING_STAGES, ttk.STAGE_ROWS)


@pytest.mark.parametrize("batch", [1, 5, 33, 1000, 1024, 4096, 65536])
def test_ring_walk_copies_every_row_once(batch):
    """The kernels' walk: warp w of block b runs ring r = w * blocks + b,
    which takes chunks r, r + rings, ...; its k-th chunk goes into stage
    k % stages, row j of the chunk into slot j. The prologue loads the first
    `stages` chunks; iteration k waits for chunk k, stores it, then refills
    the stage of chunk k - 1 with chunk k - 1 + stages. Every row must be
    copied once, and a stage is loaded only after the chunk in it was
    stored."""
    g = ttk.launch_geometry(batch)
    stage_bytes = g.rows_per_stage * ttk.ROW * 4
    assert stage_bytes % 16 == 0  # bulk copies: 16-byte sizes and offsets
    # The mbarriers lie behind the rings, 8-byte aligned.
    assert (g.warps * g.stages * stage_bytes) % 8 == 0
    assert g.shared_bytes == g.warps * g.stages * (stage_bytes + 8)
    assert g.shared_bytes <= 232_448
    chunks = -(-batch // g.rows_per_stage)
    assert 1 <= g.blocks == min(chunks, ttk.MAX_BLOCKS)
    rings = g.blocks * g.warps
    copied = np.zeros(batch, np.int64)
    busy_blocks = set()
    for block in range(g.blocks):
        for warp in range(g.warps):
            ring = warp * g.blocks + block
            n = (chunks - ring + rings - 1) // rings if ring < chunks else 0
            if n:
                busy_blocks.add(block)

            def rows_of(k):
                first = (ring + k * rings) * g.rows_per_stage
                return range(first, min(first + g.rows_per_stage, batch))

            held = {}  # stage -> (chunk, stored)

            def load(k):
                stage = k % g.stages
                assert held.get(stage, (None, True))[1], "refilled early"
                held[stage] = (k, False)

            for k in range(min(g.stages, n)):
                load(k)
            for k in range(n):
                assert held[k % g.stages] == (k, False)
                rows = rows_of(k)
                assert 1 <= len(rows) <= g.rows_per_stage
                for slot, row in enumerate(rows):
                    assert row - rows[0] == slot
                    copied[row] += 1
                held[k % g.stages] = (k, True)
                if k >= 1 and k - 1 + g.stages < n:
                    load(k - 1 + g.stages)
            assert all(stored for _, stored in held.values())
    assert busy_blocks == set(range(g.blocks))  # every block has work
    np.testing.assert_array_equal(copied, 1)


def test_argtypes_pass_pointers_and_n_rows_as_64_bit():
    lib = types.SimpleNamespace(tpu2048_bucket_gather=types.SimpleNamespace(),
                                tpu2048_bucket_scatter=types.SimpleNamespace())
    ttk._declare(lib)
    for fn in (lib.tpu2048_bucket_gather, lib.tpu2048_bucket_scatter):
        data, buckets, other, n_rows, batch, device, stream = fn.argtypes
        for t in (data, buckets, other, stream):
            assert t is ctypes.c_void_p and ctypes.sizeof(t) == 8
        assert ctypes.sizeof(n_rows) == 8 and n_rows(2**40).value == 2**40
        assert batch is ctypes.c_int and device is ctypes.c_int
        assert fn.restype is ctypes.c_int
