"""The port's tabular agent against :mod:`tpu2048.agents.tabular` and
:mod:`tpu2048.agents.tabular_fast` (the ``xla`` table backend, whose
kernels tests/test_tabular_fast.py holds bit-exact to the Pallas ones).

Everything here is bit-exact: key words, hashes, the epsilon schedule,
packed tables, probes, actions, and the table after an update, Q words
included. The update adds duplicate (state, action) deltas in batch order
from zero, as XLA's CPU scatter-add does; the duplicates test shows that
the order matters for its values.

One fault of the reference: ``tpu2048.agents.tabular_fast.resolve_updates``
takes the claimed key words of a bucket group from segment ``i`` for the
``i``-th sorted entry (``klo_set``/``khi_set`` without ``[group]``), while its
Q deltas come from the entry's own group (``q_sum[group]``). Once a group
with two or more entries precedes a claim in sorted order, the claim's key
is lost (its Q lands in a slot whose key stays 0) or written into another
bucket's image. The port writes each group's claim into its own image, as
the function's contract says; the batches with shared buckets are held to
the JAX function with that one index repaired (:func:`repaired_resolve`),
and ``test_reference_loses_claims_behind_a_shared_bucket`` pins the fault.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.agents import tabular as jtab
from tpu2048.agents import tabular_fast as jtabf
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.agents import tabular_fast as ttabf
from tpu2048_torch.eval.evaluate import greedy_tabular_policy


def to_torch(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def as_u32(t):
    return t.numpy().view(np.uint32)


def port_table(jt):
    return ttab.QTable(key_lo=to_torch(jt.key_lo), key_hi=to_torch(jt.key_hi),
                       q=to_torch(jt.q), dropped=to_torch(jt.dropped))


def assert_tables_equal(tt, jt):
    np.testing.assert_array_equal(as_u32(tt.key_lo), np.asarray(jt.key_lo))
    np.testing.assert_array_equal(as_u32(tt.key_hi), np.asarray(jt.key_hi))
    np.testing.assert_array_equal(tt.q.numpy().view(np.uint32),
                                  np.asarray(jt.q).view(np.uint32))
    assert int(tt.dropped) == int(jt.dropped)


def random_boards(rng, n, high=12):
    return rng.integers(0, high, (n, 4, 4)).astype(np.int8)


def repaired_resolve():
    """``tpu2048.agents.tabular_fast.resolve_updates`` with the claimed key
    words indexed by the entry's group, as its Q deltas are."""
    src = inspect.getsource(jtabf.resolve_updates)
    for word, name in ((0, "klo_set"), (1, "khi_set")):
        old = f"jnp.maximum(base[:, :, {word}], {name})"
        assert src.count(old) == 1
        src = src.replace(old, f"jnp.maximum(base[:, :, {word}], {name}[group])")
    namespace = dict(vars(jtabf))
    exec(src, namespace)
    return namespace["resolve_updates"]


@pytest.fixture
def jax_repaired(monkeypatch):
    monkeypatch.setattr(jtabf, "resolve_updates", repaired_resolve())


# Jitted JAX functions: one compile each instead of one per eager op.
j_rehash = jax.jit(jtab.rehash_table)
j_lookup = jax.jit(jtab.qtable_lookup)
j_choose = jax.jit(jtabf.fast_choose_actions_probed)
_j_updates = {}


def j_update(*args):
    """``fast_update``, jitted once for each ``resolve_updates`` it can
    reach (the fixture above swaps it)."""
    fn = _j_updates.setdefault(
        jtabf.resolve_updates,
        jax.jit(lambda *a: jtabf.fast_update(*a), static_argnums=4))
    return fn(*args)


def populated(seed, capacity_log2, n_seed):
    """A JAX table holding up to ``n_seed`` distinct random states with
    random Q, placed by ``rehash_table``, and the boards of its states."""
    rng = np.random.default_rng(seed)
    boards = random_boards(rng, n_seed)
    lo, hi = jtab.pack_board(jnp.asarray(boards))
    _, uniq = np.unique(np.asarray(lo).astype(np.uint64) << 32
                        | np.asarray(hi), return_index=True)
    uniq = rng.permutation(uniq)
    table = jtab.qtable_init(capacity_log2)
    slots = jnp.arange(len(uniq))
    table = j_rehash(jtab.QTable(
        key_lo=table.key_lo.at[slots].set(lo[uniq]),
        key_hi=table.key_hi.at[slots].set(hi[uniq]),
        q=table.q.at[slots].set(jnp.asarray(
            rng.normal(size=(len(uniq), 4)).astype(np.float32))),
        dropped=table.dropped))
    found = np.asarray(j_lookup(table, jnp.asarray(
        boards[uniq]))).any(-1)
    return table, boards[uniq][found]


def test_pack_board_and_hash_with_the_top_bit_set():
    rng = np.random.default_rng(0)
    boards = random_boards(rng, 512, high=16)
    boards[:256, 1, 3] = rng.integers(8, 16, 256)  # bit 31 of lo
    boards[128:384, 3, 3] = rng.integers(8, 16, 256)  # bit 31 of hi
    boards[0, 0, 0] = 17  # clips to 15
    t_lo, t_hi = ttab.pack_board(torch.from_numpy(boards))
    j_lo, j_hi = jtab.pack_board(jnp.asarray(boards))
    assert t_lo.dtype == t_hi.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(t_lo), np.asarray(j_lo))
    np.testing.assert_array_equal(as_u32(t_hi), np.asarray(j_hi))
    assert (np.asarray(j_lo) >= 2**31).any() and (np.asarray(j_hi) >= 2**31).any()
    for log2 in (0, 4, 12, 21, 25, 32):
        np.testing.assert_array_equal(
            ttab._hash(t_lo, t_hi, 1 << log2).numpy(),
            np.asarray(jtab._hash(j_lo, j_hi, 1 << log2)), err_msg=str(log2))


@pytest.mark.parametrize("total", [10, 100, 333])
def test_epsilon_schedule_is_bit_exact(total):
    cfg = ttab.TabularConfig(total_epochs=total)
    jcfg = jtab.TabularConfig(total_epochs=total)
    epochs = np.concatenate([
        np.arange(0, 1.2 * total, 0.25), [0.3 * total, 0.6 * total,
                                          0.8 * total, 1e6]]).astype(np.float32)
    got = ttab.epsilon_for_epoch(torch.from_numpy(epochs), cfg)
    want = np.asarray(jtab.epsilon_for_epoch(jnp.asarray(epochs), jcfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_and_unpack_match_jax():
    jt, _ = populated(1, 8, 64)
    tt = port_table(jt)
    packed = ttabf.pack_qtable(tt)
    np.testing.assert_array_equal(
        as_u32(packed.data), np.asarray(jtabf.pack_qtable(jt).data))
    assert packed.capacity == jt.capacity
    np.testing.assert_array_equal(packed.occupied.numpy(),
                                  np.asarray(jt.occupied))
    assert_tables_equal(ttabf.unpack_qtable(packed), jt)


def test_lookup_and_epsilon_greedy_with_replayed_draws():
    jt, seen = populated(2, 8, 64)
    jpacked = jtabf.pack_qtable(jt)
    packed = ttabf.pack_qtable(port_table(jt))
    rng = np.random.default_rng(3)
    boards = np.concatenate([random_boards(rng, 48), seen[:16]])
    np.testing.assert_array_equal(
        ttabf.fast_lookup(packed, torch.from_numpy(boards)).numpy(),
        np.asarray(jtabf.fast_lookup(jpacked, jnp.asarray(boards))))

    key = jax.random.PRNGKey(4)
    k_expl, k_act = jax.random.split(key)
    draws = ttabf.ReplayDraws([(
        to_torch(jax.random.uniform(k_expl, (64,))),
        to_torch(jax.random.randint(k_act, (64,), 0, 4)))])
    eps = np.float32(0.5)
    j_actions, j_probe = j_choose(
        jpacked, jnp.asarray(boards), eps, key)
    t_actions, t_probe = ttabf.fast_choose_actions_probed(
        packed, torch.from_numpy(boards), torch.tensor(eps), draws)
    np.testing.assert_array_equal(t_actions.numpy(), np.asarray(j_actions))
    for t, j in zip(t_probe, j_probe):
        np.testing.assert_array_equal(
            t.numpy().view(np.uint32) if t.dtype == torch.int32
            and np.asarray(j).dtype == np.uint32 else t.numpy(),
            np.asarray(j))
    assert (t_probe[4].numpy() >= 0).sum() == 16  # the seen states match

    policy = greedy_tabular_policy(port_table(jt))
    legal = torch.ones((64, 4), dtype=torch.bool)
    q = np.asarray(j_lookup(jt, jnp.asarray(boards)))
    np.testing.assert_array_equal(
        policy(torch.from_numpy(boards), legal).numpy(), q.argmax(-1))


def update_both(jpacked, packed, boards, actions, targets, lr):
    """One choose (epsilon 0) + update on both packages; returns both."""
    key = jax.random.PRNGKey(0)
    _, j_probe = j_choose(
        jpacked, jnp.asarray(boards), 0.0, key)
    jpacked = j_update(jpacked, j_probe, jnp.asarray(actions),
                                jnp.asarray(targets), lr)
    b = boards.shape[0]
    draws = ttabf.ReplayDraws([(torch.ones(b), torch.zeros(b,
                                                          dtype=torch.int32))])
    _, t_probe = ttabf.fast_choose_actions_probed(
        packed, torch.from_numpy(boards), torch.tensor(0.0), draws)
    ptr = packed.data.data_ptr()
    packed = ttabf.fast_update(packed, t_probe, torch.from_numpy(actions),
                               torch.from_numpy(targets), lr)
    assert packed.data.data_ptr() == ptr  # the scatter wrote in place
    np.testing.assert_array_equal(as_u32(packed.data)[:-1],
                                  np.asarray(jpacked.data)[:-1])
    assert int(packed.dropped) == int(jpacked.dropped)
    return jpacked, packed


def test_duplicates_add_in_batch_order():
    """Three and four duplicates of (state, action), on a fresh and on a
    stored state: the deltas add as ((0 + d0) + d1) + d2 from the pre-update
    Q, then onto the base."""
    jt, seen = populated(5, 8, 40)
    jpacked = jtabf.pack_qtable(jt)
    packed = ttabf.pack_qtable(port_table(jt))
    fresh = random_boards(np.random.default_rng(6), 1)
    boards = np.concatenate([fresh] * 3 + [seen[:1]] * 4)
    actions = np.array([1, 1, 1, 2, 2, 2, 2], np.int32)
    targets = np.array([3e7, 1.3, 1.3, 2.1e6, -0.37, 1.3e-3, 5.5],
                       np.float32)
    d = np.float32(0.1) * targets[:3]
    seq = (np.float32(0) + d[0] + d[1]) + d[2]
    assert seq != d[0] + (d[1] + d[2])  # the order shows in the values
    jpacked, packed = update_both(jpacked, packed, boards, actions, targets,
                                  0.1)
    q = ttabf.fast_lookup(packed, torch.from_numpy(fresh)).numpy()
    assert q[0, 1] == seq


def test_claim_race_goes_to_the_lowest_index():
    """Capacity 16 is one bucket: two fresh states race for slot 0; the
    first in the batch claims it, the second drops and counts."""
    rng = np.random.default_rng(7)
    boards = random_boards(rng, 2)
    jpacked, packed = update_both(
        jtabf.packed_init(4), ttabf.packed_init(4), boards,
        np.array([2, 3], np.int32), np.array([4.0, 8.0], np.float32), 1.0)
    assert int(packed.dropped) == 1
    np.testing.assert_array_equal(
        ttabf.fast_lookup(packed, torch.from_numpy(boards)).numpy(),
        [[0, 0, 4.0, 0], [0, 0, 0, 0]])


def test_full_bucket_drops_and_counts():
    rng = np.random.default_rng(8)
    boards = random_boards(rng, 17)
    jpacked, packed = jtabf.packed_init(4), ttabf.packed_init(4)
    one = np.ones(1, np.float32)
    for i in range(16):
        jpacked, packed = update_both(jpacked, packed, boards[i:i + 1],
                                      np.zeros(1, np.int32), one, 1.0)
    assert int(packed.occupied.sum()) == 16 and int(packed.dropped) == 0
    jpacked, packed = update_both(jpacked, packed, boards[16:],
                                  np.zeros(1, np.int32), one, 1.0)
    assert int(packed.dropped) == 1


def mixed_batch(seed):
    """A batch drawn from a small pool of states on a table of 4 buckets:
    matched, fresh, duplicate, racing and full-bucket entries at once."""
    jt, seen = populated(seed, 6, 40)
    rng = np.random.default_rng(seed + 1)
    pool = np.concatenate([seen[:8], random_boards(rng, 24)])
    boards = pool[rng.integers(0, len(pool), 64)]
    actions = rng.integers(0, 4, 64).astype(np.int32)
    targets = (rng.normal(size=64) * 100).astype(np.float32)
    return jt, boards, actions, targets


def test_mixed_batch_update_is_bit_exact(jax_repaired):
    jt, boards, actions, targets = mixed_batch(9)
    jpacked, packed = update_both(jtabf.pack_qtable(jt),
                                  ttabf.pack_qtable(port_table(jt)), boards,
                                  actions, targets, 0.1)
    assert int(packed.dropped) > 0


def test_reference_loses_claims_behind_a_shared_bucket():
    jt, boards, actions, targets = mixed_batch(9)
    jpacked = jtabf.pack_qtable(jt)
    _, probe = j_choose(
        jpacked, jnp.asarray(boards), 0.0, jax.random.PRNGKey(0))
    jpacked = j_update(jpacked, probe, jnp.asarray(actions),
                                jnp.asarray(targets), 0.1)
    slots = np.asarray(jpacked.data)[:-1].reshape(-1, 8)
    orphans = (slots[:, :2] == 0).all(1) & (slots[:, 2:6] != 0).any(1)
    assert orphans.any()  # Q written into slots whose key stayed 0

    packed = ttabf.pack_qtable(port_table(jt))
    draws = ttabf.ReplayDraws([(torch.ones(64),
                                torch.zeros(64, dtype=torch.int32))])
    _, t_probe = ttabf.fast_choose_actions_probed(
        packed, torch.from_numpy(boards), torch.tensor(0.0), draws)
    packed = ttabf.fast_update(packed, t_probe, torch.from_numpy(actions),
                               torch.from_numpy(targets), 0.1)
    slots = packed.data.numpy()[:-1].reshape(-1, 8)
    assert not ((slots[:, :2] == 0).all(1) & (slots[:, 2:6] != 0).any(1)).any()
    # Each bucket with a claim stores exactly one new state, its winner.
    claimed = ((t_probe[4] < 0) & (t_probe[5] >= 0)).numpy()
    n = int(claimed.sum())
    draws = ttabf.ReplayDraws([(torch.ones(n),
                                torch.zeros(n, dtype=torch.int32))])
    _, after = ttabf.fast_choose_actions_probed(
        packed, torch.from_numpy(boards[claimed]), torch.tensor(0.0), draws)
    stored = np.unique(boards[claimed][after[4].numpy() >= 0].reshape(-1, 16),
                       axis=0)
    assert len(stored) == len(np.unique(t_probe[2].numpy()[claimed]))


def test_npz_files_interoperate(tmp_path):
    jt, seen = populated(11, 8, 64)
    rng = np.random.default_rng(12)
    boards = np.concatenate([seen[:32], random_boards(rng, 32)])
    want = np.asarray(j_lookup(jt, jnp.asarray(boards)))
    assert (np.asarray(jt.key_lo) >= 2**31).any()

    port_path = str(tmp_path / "port.npz")
    ttab.save_qtable(port_path, port_table(jt))
    with np.load(port_path) as z:
        assert z["key_lo"].dtype == np.uint32 and str(z["layout"]) == "bucketed"
    from_port = jtab.load_qtable(port_path)
    np.testing.assert_array_equal(
        np.asarray(j_lookup(from_port, jnp.asarray(boards))), want)

    jax_path = str(tmp_path / "jax.npz")
    jtab.save_qtable(jax_path, jt)
    from_jax = ttab.load_qtable(jax_path)
    assert_tables_equal(from_jax, jt)
    np.testing.assert_array_equal(
        ttabf.fast_lookup(ttabf.pack_qtable(from_jax),
                          torch.from_numpy(boards)).numpy(), want)

    # int32 key words load to the same table.
    int_path = str(tmp_path / "int32.npz")
    with np.load(jax_path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["key_lo"] = arrays["key_lo"].view(np.int32)
    arrays["key_hi"] = arrays["key_hi"].view(np.int32)
    np.savez(int_path, **arrays)
    assert_tables_equal(ttab.load_qtable(int_path), jt)


def test_rehash_of_a_linear_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    boards = random_boards(rng, 200)
    lo, hi = jtab.pack_board(jnp.asarray(boards))
    key = np.asarray(lo).astype(np.uint64) << 32 | np.asarray(hi)
    _, uniq = np.unique(key, return_index=True)
    n = len(uniq)
    jt = jtab.qtable_init(12)
    slots = rng.choice(jt.capacity, size=n, replace=False)
    jt = jtab.QTable(
        key_lo=jt.key_lo.at[slots].set(lo[uniq]),
        key_hi=jt.key_hi.at[slots].set(hi[uniq]),
        q=jt.q.at[slots].set(jnp.asarray(
            rng.normal(size=(n, 4)).astype(np.float32))),
        dropped=jt.dropped)
    want = j_rehash(jt)
    assert_tables_equal(ttab.rehash_table(port_table(jt)), want)

    # A file without a layout is the linear one and is rehashed on load.
    path = str(tmp_path / "linear.npz")
    np.savez(path, key_lo=np.asarray(jt.key_lo), key_hi=np.asarray(jt.key_hi),
             q=np.asarray(jt.q), dropped=np.asarray(jt.dropped))
    assert_tables_equal(ttab.load_qtable(path), want)
