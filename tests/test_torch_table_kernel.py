"""The table kernels' plain versions against the JAX package's ``_xla``
twins (which tests/test_tabular_fast.py holds bit-exact to the Pallas
kernels), on random tables whose words include the top bit.

The scatter's equality covers rows ``[0, NB)`` only: several entries write
the trash row ``NB`` and may land in any order, and nothing reads it.
"""

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
