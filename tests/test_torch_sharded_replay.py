"""The port's sharded replay (``tpu2048_torch.replay.sharded``) against
``tpu2048.replay.sharded`` on the same numpy-seeded transitions, for S in
{1, 2, 4} shards of a 64-slot buffer, and the sharded draw sources.

Every slot array, ``ptr``, ``size`` and ``max_priority`` of every shard is
held bit for bit after adds (with masks, across the rings' wraps), priority
updates and the per-shard prune; sampled batches and indices at the indices
JAX's split keys draw are equal too. Only PER's importance weights go
through float32 sums whose order differs: they are held to ``W_RTOL``, as
``tests/test_torch_replay.py`` holds the flat buffer's. With one shard the
sharded operations are the flat buffer's, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_replay import BATCH_KEYS, FIELDS, transitions
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.replay import sharded as jsh
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.env import env as tenv
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.replay import buffer as tflat
from tpu2048_torch.replay import sharded as tsh

C, B = 64, 16
W_RTOL = 1e-5  # PER weights: a float32 sum of C/S terms in another order
SHARDS = (1, 2, 4)


def from_jax(jb):
    """The port's sharded buffer holding a JAX sharded buffer's leaves
    (``np.asarray`` of each, a zero trash row appended to every shard);
    one shard gives the flat buffer."""
    arrays = {}
    for name in FIELDS:
        x = torch.from_numpy(np.array(getattr(jb, name)))
        arrays[name] = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    scalars = {name: torch.from_numpy(np.array(getattr(jb, name)))
               for name in ("max_priority", "ptr", "size")}
    buf = tflat.ReplayBuffer(**arrays, **scalars)
    return tsh.shard(buf, 0) if jb.ptr.shape[0] == 1 else buf


def lead(x, shards):
    return x if shards > 1 else x.unsqueeze(0)


def assert_equal(tb, jb, shards):
    c = C // shards
    for name in FIELDS:
        np.testing.assert_array_equal(
            lead(getattr(tb, name), shards).numpy()[:, :c],
            np.asarray(getattr(jb, name)), name)
    for name in ("ptr", "size", "max_priority"):
        np.testing.assert_array_equal(
            lead(getattr(tb, name), shards).numpy(),
            np.asarray(getattr(jb, name)), name)


def filled(shards, seed, adds=7):
    """Both packages' buffers after ``adds`` masked inserts of B envs (the
    rings wrap); the masks leave some shards emptier than others."""
    rng = np.random.default_rng(seed)
    jb = jsh.sharded_init(C, shards)
    tb = tsh.sharded_init(C, shards)
    assert_equal(tb, jb, shards)
    add = jax.jit(jsh.sharded_add)
    for _ in range(adds):
        tr = transitions(rng, B, done_rate=0.2)
        mask = rng.random(B) < 0.75
        jb = add(jb, *map(jnp.asarray, tr), jnp.asarray(mask))
        out = tsh.sharded_add(tb, *map(torch.from_numpy, tr),
                              torch.from_numpy(mask))
        assert out is tb
    return jb, tb


@pytest.mark.parametrize("shards", SHARDS)
def test_init_and_add_match_jax(shards):
    jb, tb = filled(shards, seed=shards)
    assert_equal(tb, jb, shards)
    assert tsh.num_shards(tb) == shards
    assert int(tsh.total_size(tb)) == int(jsh.total_size(jb))
    np.testing.assert_array_equal(tsh.shard_sizes(tb).numpy().reshape(-1),
                                  np.asarray(jb.size))
    # The helper that carries JAX's leaves into the port builds the same.
    assert_equal(from_jax(jb), jb, shards)


def jax_indices(key, shards, sizes, per):
    """The uniform draw of ``jsh.sharded_sample``, replayed from its split
    keys: shard s draws ``randint(keys[s], (per,), 0, max(size_s, 1))``."""
    keys = jax.random.split(key, shards)
    return np.stack([np.asarray(jax.random.randint(
        keys[s], (per,), 0, max(int(sizes[s]), 1))) for s in range(shards)])


@pytest.mark.parametrize("alpha", [0.0, 0.6])
@pytest.mark.parametrize("shards", SHARDS)
def test_sample_matches_jax(shards, alpha):
    jb, _ = filled(shards, seed=10 + shards)
    batch = 16
    key = jax.random.PRNGKey(shards)
    jbatch, jidx, jw = jax.jit(functools.partial(
        jsh.sharded_sample, batch_size=batch, alpha=alpha, beta=0.4))(
            jb, key)
    if alpha == 0.0:
        np.testing.assert_array_equal(
            jax_indices(key, shards, np.asarray(jb.size), batch // shards),
            np.asarray(jidx))
    tb = from_jax(jb)
    tbatch, tidx, tw = tsh.sharded_sample(
        tb, batch, alpha, 0.4, torch.from_numpy(np.array(jidx)))
    # A flat buffer (one shard) returns flat indices, as the flat sample.
    assert tidx.shape == ((batch,) if shards == 1
                          else (shards, batch // shards))
    np.testing.assert_array_equal(tidx.numpy().reshape(np.shape(jidx)),
                                  np.asarray(jidx))
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]), k)
    assert tbatch["action"].dtype == torch.int64
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
    assert tw.shape == (batch,)


@pytest.mark.parametrize("shards", SHARDS)
def test_update_priorities_matches_jax(shards):
    jb, _ = filled(shards, seed=20 + shards)
    rng = np.random.default_rng(shards)
    per = 8 // shards
    idx = np.stack([rng.choice(C // shards, per, replace=False)
                    for _ in range(shards)]).astype(np.int32)
    td = rng.normal(0, 3, 8).astype(np.float32)
    want = jax.jit(jsh.sharded_update_priorities)(jb, jnp.asarray(idx),
                                                  jnp.asarray(td))
    tb = from_jax(jb)
    tsh.sharded_update_priorities(tb, torch.from_numpy(idx),
                                  torch.from_numpy(td))
    assert_equal(tb, want, shards)


@pytest.mark.parametrize("shards", SHARDS)
def test_prune_matches_jax_per_shard(shards):
    jb, _ = filled(shards, seed=30 + shards, adds=9)
    want = jax.jit(jsh.sharded_prune, static_argnums=1)(jb, 2)
    got = tsh.sharded_prune(from_jax(jb), 2)
    assert_equal(got, want, shards)
    assert int(tsh.total_size(got)) < int(jsh.total_size(jb))


def test_one_shard_is_the_flat_buffer():
    """With S=1 every sharded operation gives the flat one's results."""
    rng = np.random.default_rng(7)
    flat = tflat.replay_init(C)
    one = tsh.sharded_init(C, 1)
    assert tsh.shard(one, 0) is one and one.ptr.dim() == 0
    for _ in range(7):
        tr = [torch.from_numpy(x) for x in transitions(rng, B)]
        mask = torch.from_numpy(rng.random(B) < 0.7)
        tflat.replay_add(flat, *tr, mask)
        tsh.sharded_add(one, *tr, mask)
    idx = torch.from_numpy(rng.integers(0, C, 8))
    td = torch.from_numpy(rng.normal(0, 2, 8).astype(np.float32))
    fb, fi, fw = tflat.replay_sample(flat, 8, 0.6, 0.4, idx)
    sb, si, sw = tsh.sharded_sample(one, 8, 0.6, 0.4, idx)
    assert torch.equal(si.reshape(-1), fi) and torch.equal(sw, fw)
    for k in BATCH_KEYS:
        assert torch.equal(sb[k], fb[k]), k
    tflat.replay_update_priorities(flat, idx, td)
    tsh.sharded_update_priorities(one, si, td)
    flat = tflat.prune_low_score_episodes(flat, 2)
    one = tsh.sharded_prune(one, 2)
    for name in FIELDS + ("ptr", "size", "max_priority"):
        assert torch.equal(getattr(one, name), getattr(flat, name)), name


def test_capacity_must_divide():
    with pytest.raises(ValueError, match="not divisible"):
        tsh.sharded_init(10, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.sharded_add(tsh.sharded_init(C, 4), *[
            torch.from_numpy(x) for x in
            transitions(np.random.default_rng(0), 6)],
            torch.ones(6, dtype=torch.bool))


def test_sharded_sources_draw_each_shards_lanes_from_its_own_source():
    """A sharded source's draws are its shards' sources' draws side by
    side; one shard draws exactly what the unsharded source does."""
    seeds = (11, 12, 13, 14)
    bits = tfast.ShardedBits([tfast.GeneratorBits(s, "cpu") for s in seeds])
    rows = bits(32)
    for i, s in enumerate(seeds):
        assert torch.equal(rows[:, 8 * i:8 * (i + 1)],
                           tfast.GeneratorBits(s, "cpu")(8))
    assert torch.equal(tfast.ShardedBits([tfast.GeneratorBits(5, "cpu")])(
        16), tfast.GeneratorBits(5, "cpu")(16))
    with pytest.raises(ValueError, match="not divisible"):
        bits(30)

    draws = tdqn.ShardedDraws([tdqn.GeneratorDraws(s, "cpu") for s in seeds])
    got = draws.select(32)
    for i, s in enumerate(seeds):
        want = tdqn.GeneratorDraws(s, "cpu").select(8)
        for g, w in zip(got, want):
            assert torch.equal(g[8 * i:8 * (i + 1)], w)
    buf = tsh.sharded_init(C, 4)
    tsh.sharded_add(buf, *[torch.from_numpy(x) for x in transitions(
        np.random.default_rng(1), 32)], torch.ones(32, dtype=torch.bool))
    idx = draws.indices(buf, 16, 0.0)
    assert idx.shape == (4, 4) and int(idx.max()) < 8

    spawns = tenv.ShardedSpawns([tenv.GeneratorSpawns(s, "cpu")
                                 for s in seeds[:2]])
    fresh = spawns.fresh(8)
    assert torch.equal(fresh[:4], tenv.GeneratorSpawns(11, "cpu").fresh(4))
    assert torch.equal(fresh[4:], tenv.GeneratorSpawns(12, "cpu").fresh(4))
    idx, val = spawns.spawn(fresh)
    a = tenv.GeneratorSpawns(11, "cpu")
    a.fresh(4)
    wi, wv = a.spawn(fresh[:4])
    assert torch.equal(idx[:4], wi) and torch.equal(val[:4], wv)
