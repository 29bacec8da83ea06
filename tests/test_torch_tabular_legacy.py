"""The port's legacy two-array Q-table (``table_backend="legacy"``) against
:mod:`tpu2048.agents.tabular` on the same tables, boards and randomness.

Everything on the agent's side is bit-exact, Q words included: the probe,
the lookup, the targets, the epsilon-greedy choice on JAX's own draws, and
the table after an update with and without the choice's probe. The update
batch holds the cases where the order of a scatter decides the result:
fresh keys that race for one free slot (the last in batch order keeps it),
one state updated several times with deltas whose float32 sum depends on
the order, an entry whose bucket is full (``dropped``), and an all-zero
key. The trainer on the legacy table is held to JAX's legacy trainer with
the tolerance of ``test_torch_tabular_train.py`` (the shaped reward's
float32 ulps), then driven through the CLI and read back by ``eval``.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tabular import (assert_tables_equal, populated, port_table,
                                random_boards, to_torch)
from test_torch_tabular_train import (B, SEED, STEPS, assert_close,
                                      jax_randomness, reset_rows)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents import tabular as jtab
from tpu2048.env import EnvConfig as JaxEnvConfig
from tpu2048.training import tabular as jtrain
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.agents import tabular_fast as ttabf
from tpu2048_torch.cli.main import main
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.training import tabular as ttrain

LOG2 = 8  # 16 buckets of 16 slots: buckets fill and collide
LR = 0.1

j_probe = jax.jit(jtab._probe)
j_lookup = jax.jit(jtab.qtable_lookup)
j_targets = jax.jit(jtab.q_learning_targets, static_argnums=4)
j_choose = jax.jit(jtab.choose_actions_probed)
j_update = jax.jit(jtab.qtable_update, static_argnums=4)
j_update_probed = jax.jit(
    lambda t, b, a, y, p: jtab.qtable_update(t, b, a, y, LR, probe=p))


def bucket_of(boards, log2=LOG2):
    lo, hi = jtab.pack_board(jnp.asarray(boards))
    return np.asarray(jtab._hash(lo, hi, (1 << log2) // jtab.PROBES))


def update_batch(seed):
    """A table with one full bucket, and a batch of 64 boards: stored
    states, fresh states, three fresh keys racing for one free slot, one
    state five times with order-sensitive targets, two entries in the full
    bucket and an all-zero board; its actions and targets."""
    jt, seen = populated(seed, LOG2, 220)
    rng = np.random.default_rng(seed + 1)
    occupied = np.asarray(jt.occupied).reshape(-1, jtab.PROBES)
    full = np.flatnonzero(occupied.all(1))
    assert full.size, "no full bucket"
    fresh = random_boards(rng, 4000, high=16)
    fresh_lo, _ = jtab.pack_board(jnp.asarray(fresh))
    known = set(np.asarray(jtab.pack_board(jnp.asarray(seen))[0]).tolist())
    fresh = fresh[[int(x) not in known for x in np.asarray(fresh_lo)]]
    buckets = bucket_of(fresh)
    into_full = fresh[buckets == full[0]][:2]
    open_bucket = next(b for b in np.unique(buckets)
                       if not occupied[b].all() and (buckets == b).sum() >= 3)
    racing = fresh[buckets == open_bucket][:3]
    assert len(into_full) == 2 and len(racing) == 3
    boards = np.concatenate([
        seen[:20], fresh[:24], racing, np.repeat(fresh[24:25], 5, 0),
        into_full, np.zeros((1, 4, 4), np.int8), seen[20:29]])
    perm = rng.permutation(len(boards))
    boards = boards[perm]
    actions = rng.integers(0, 4, len(boards)).astype(np.int32)
    targets = rng.normal(size=len(boards)).astype(np.float32)
    # The five copies of one state act alike, with targets whose float32
    # sum depends on the order in which they are added.
    copies = np.flatnonzero(np.isin(perm, np.arange(47, 52)))
    actions[copies] = 2
    targets[copies] = np.array([1e7, 1.0, -1e7, 3.0, 0.5], np.float32)
    return jt, boards, actions, targets


def test_probe_and_lookup_match_jax():
    jt, boards, _, _ = update_batch(0)
    tt = port_table(jt)
    lo, hi = ttab.pack_board(torch.from_numpy(boards))
    t_match, t_free = ttab._probe(tt, lo, hi)
    j_match, j_free = j_probe(jt, *jtab.pack_board(jnp.asarray(boards)))
    assert t_match.dtype == t_free.dtype == torch.int32
    np.testing.assert_array_equal(t_match.numpy(), np.asarray(j_match))
    np.testing.assert_array_equal(t_free.numpy(), np.asarray(j_free))
    # Stored states match; the full bucket has no free slot; zero matches
    # and claims nothing.
    assert (t_match.numpy() >= 0).sum() >= 29
    assert ((t_match.numpy() < 0) & (t_free.numpy() < 0)).sum() >= 3
    np.testing.assert_array_equal(
        ttab.qtable_lookup(tt, torch.from_numpy(boards)).numpy(),
        np.asarray(j_lookup(jt, jnp.asarray(boards))))


def test_targets_match_jax():
    jt, boards, _, targets = update_batch(1)
    dones = np.arange(len(boards)) % 3 == 0
    got = ttab.q_learning_targets(port_table(jt), torch.from_numpy(targets),
                                  torch.from_numpy(boards),
                                  torch.from_numpy(dones), 0.9)
    want = j_targets(jt, jnp.asarray(targets), jnp.asarray(boards),
                     jnp.asarray(dones), 0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jax_draws(key, b):
    """The explore uniforms and random actions that JAX's
    ``choose_actions_probed`` draws from ``key``."""
    k_expl, k_act = jax.random.split(key)
    return ttabf.ReplayDraws([(to_torch(jax.random.uniform(k_expl, (b,))),
                               to_torch(jax.random.randint(k_act, (b,), 0,
                                                           4)))])


def test_choose_actions_probed_matches_jax():
    jt, boards, _, _ = update_batch(2)
    tt = port_table(jt)
    key = jax.random.PRNGKey(7)
    eps = np.float32(0.4)
    j_actions, j_probe_out = j_choose(jt, jnp.asarray(boards), eps, key)
    t_actions, t_probe = ttab.choose_actions_probed(
        tt, torch.from_numpy(boards), torch.tensor(eps),
        jax_draws(key, len(boards)))
    np.testing.assert_array_equal(t_actions.numpy(), np.asarray(j_actions))
    for t, j in zip(t_probe, j_probe_out):
        j = np.asarray(j)
        np.testing.assert_array_equal(
            t.numpy().view(np.uint32) if j.dtype == np.uint32 else t.numpy(),
            j)
    greedy = np.asarray(j_lookup(jt, jnp.asarray(boards))).argmax(-1)
    explored = t_actions.numpy() != greedy
    assert explored.any() and not explored.all()
    np.testing.assert_array_equal(
        ttab.choose_actions(tt, torch.from_numpy(boards), torch.tensor(eps),
                            jax_draws(key, len(boards))).numpy(),
        np.asarray(j_actions))


@pytest.mark.parametrize("with_probe", [False, True],
                         ids=["reprobe", "probe"])
def test_update_matches_jax(with_probe):
    jt, boards, actions, targets = update_batch(3)
    tt = port_table(jt)
    before = tt.q.clone()
    if with_probe:
        key = jax.random.PRNGKey(8)
        _, j_p = j_choose(jt, jnp.asarray(boards), np.float32(0.0), key)
        _, t_p = ttab.choose_actions_probed(
            tt, torch.from_numpy(boards), torch.tensor(np.float32(0.0)),
            jax_draws(key, len(boards)))
        want = j_update_probed(jt, jnp.asarray(boards), jnp.asarray(actions),
                               jnp.asarray(targets), j_p)
    else:
        t_p = None
        want = j_update(jt, jnp.asarray(boards), jnp.asarray(actions),
                        jnp.asarray(targets), LR)
    got = ttab.qtable_update(tt, torch.from_numpy(boards),
                             torch.from_numpy(actions),
                             torch.from_numpy(targets), LR, probe=t_p)
    assert_tables_equal(got, want)
    # The cases the batch is built for all happened: the race and the full
    # bucket dropped entries, and the repeated state's deltas, added in
    # batch order, give another value than in the reverse order.
    assert int(got.dropped) >= 4
    first = np.flatnonzero(targets == np.float32(1e7))
    slot = int(ttab._probe(got, *ttab.pack_board(
        torch.from_numpy(boards[first])))[0])
    deltas = np.float32(LR) * np.array([1e7, 1.0, -1e7, 3.0, 0.5],
                                       np.float32)

    def fold(values):
        acc = np.float32(0.0)
        for v in values:
            acc = np.float32(acc + v)
        return acc

    assert got.q[slot, 2].item() == fold(deltas) != fold(deltas[::-1])
    assert not torch.equal(got.q, before)


def test_update_on_an_empty_table_and_a_repeat():
    """Every entry fresh, then the same batch again. A bucket's fresh keys
    all claim its first free slot, so an update stores at most one new key
    a bucket (16 here): the rest drop, and the second update stores
    more."""
    rng = np.random.default_rng(4)
    boards = random_boards(rng, 96, high=6)
    boards[48:] = boards[:48]
    actions = rng.integers(0, 4, 96).astype(np.int32)
    targets = rng.normal(size=96).astype(np.float32)
    jt = jtab.qtable_init(LOG2)
    tt = port_table(jt)
    stored = []
    for _ in range(2):
        jt = j_update(jt, jnp.asarray(boards), jnp.asarray(actions),
                      jnp.asarray(targets), LR)
        tt = ttab.qtable_update(tt, torch.from_numpy(boards),
                                torch.from_numpy(actions),
                                torch.from_numpy(targets), LR)
        assert_tables_equal(tt, jt)
        stored.append(int(tt.occupied.sum()))
    assert stored[0] <= 16 < stored[1] and int(tt.dropped) > 96


def legacy_configs(steps, exploration):
    agent = dict(capacity_log2=10, exploration_rate=exploration,
                 exploration_min=min(exploration, 0.01))
    jcfg = jtrain.TabularTrainConfig(
        agent=jtab.TabularConfig(**agent), env=JaxEnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=steps, fast_backend="lax",
        table_backend="legacy", seed=SEED)
    tcfg = ttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(**agent), env=EnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=steps, table_backend="legacy",
        seed=SEED)
    return jcfg, tcfg


def test_legacy_train_chunk_matches_jax():
    jcfg, tcfg = legacy_configs(STEPS, 0.5)
    js = jtrain.init_train_state(jcfg)
    bits, draws = jax_randomness(js, STEPS)
    replay = tfast.ReplayBits([to_torch(reset_rows(js.env_state.boards)),
                               *bits])
    ts = ttrain.init_train_state(tcfg, replay)
    assert isinstance(ts.table, ttab.QTable)
    js, j_eps = jax.jit(lambda s: jtrain.train_chunk(jcfg, s))(js)
    ts, t_eps = ttrain.train_chunk(tcfg, ts, replay, ttabf.ReplayDraws(draws))
    assert float(t_eps) == float(j_eps)
    for name in ("key_lo", "key_hi"):
        np.testing.assert_array_equal(
            getattr(ts.table, name).numpy().view(np.uint32),
            np.asarray(getattr(js.table, name)), name)
    assert int(ts.table.dropped) == int(js.table.dropped)
    assert_close(ts.table.q.numpy(), js.table.q, "q")
    for name in ("boards", "score", "episode_steps", "prev_max"):
        np.testing.assert_array_equal(
            getattr(ts.env_state, name).numpy(),
            np.asarray(getattr(js.env_state, name)), name)
    for name in ("episodes_done", "env_steps", "best_tile", "action_counts"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert int(ts.table.occupied.sum()) > B


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("backend", ["legacy", "pallas"])
def test_cli_train_and_eval_on_cpu(backend, tmp_path):
    table, log = str(tmp_path / "q.npz"), str(tmp_path / "m.jsonl")
    rc, _ = run_cli(["train", "tabular", "--cpu", "--episodes", "8",
                     "--batch", "16", "--capacity-log2", "10",
                     "--steps-per-chunk", "64", "--table-backend", backend,
                     "--save", table, "--log", log, "--seed", "1"])
    assert rc == 0
    from tpu2048_torch.metrics.logging import read_jsonl

    last = read_jsonl(log)[-1]
    assert last["episodes"] >= 8 and last["q_states"] > 0
    loaded = jtab.load_qtable(table)  # the JAX package reads the file
    assert int(loaded.occupied.sum()) == last["q_states"]
    assert int(loaded.dropped) == last["dropped_updates"]
    rc, out = run_cli(["eval", "--policy", "tabular", "--table", table,
                       "--games", "8", "--eval-batch", "8", "--cpu",
                       "--reward", "shaped"])
    assert rc == 0
    assert json.loads(out)["games"] == 8


def test_resolve_table_backend():
    for name, want in (("auto", "packed"), ("pallas", "packed"),
                       ("legacy", "legacy")):
        cfg = ttrain.TabularTrainConfig(table_backend=name)
        assert ttrain.resolve_table_backend(cfg) == want
    for name in ("xla", "interpret", "nope"):
        with pytest.raises(ValueError):
            ttrain.resolve_table_backend(
                ttrain.TabularTrainConfig(table_backend=name))
