"""The port's DQN agent against ``tpu2048.agents.dqn`` on the same inputs,
narrow networks (features 32, hidden 16, 1 block) in float32.

Bit for bit: ``select_actions`` on JAX's own draws (on a head whose
actions are 0.05 apart, far beyond float32 sum-order noise), the dedup
rule over a trajectory, and the epsilon and LR schedules (the port computes
them in float32 as JAX does; ``maybe_decay_lr`` over 50 qualifying episodes
and its ``n == 0`` pass-through).

Within tolerances, both sides in float32 with only the order of the sums
differing:
- targets, loss and |TD|: ``RTOL`` of max(1, |value|);
- gradients: ``GRAD_TOL`` x the tensor's max |g|;
- Adam's moments and the parameters after 1 and 3 steps: ``RTOL`` of
  max(1, |value|) for the moments' scale, and for the parameters
  ``PARAM_ATOL``. Adam's first steps move each weight by about
  ``lr * sign(g)``, so an element whose gradient lies within
  ``GRAD_TOL`` x max|g| of 0 (float noise) may take either sign: those
  elements are held to ``2 * lr * steps`` instead, and must stay under
  1 in 1000 (18 of 36,444 parameter-steps here). Gradients that are exactly
  0 on both sides (dead units, one-hot channels no board sets) move
  neither side and count as ordinary elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.agents import dqn as jdqn
from tpu2048.ops import board as jboard
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.models import dqn as tmodels

NARROW = dict(features=32, hidden=16, num_blocks=1, bf16=False, dropout=0.0)
RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_ATOL = 1e-6
B = 32


def jnp_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tie_free(params, seed=0):
    """The head scaled down and its biases 0.05 apart, so that float32
    sum-order differences cannot flip an argmax."""
    params = jax.tree.map(np.array, params)
    params["head"]["kernel"] *= 0.02
    rng = np.random.default_rng(seed)
    params["head"]["bias"][:] = 0.05 * rng.permutation(4)
    return params


def carry(jstate, tstate):
    """Carry a JAX train state into the port's (in place)."""
    adam = jstate.opt_state.inner_state[0]
    tdqn.load_jax_train_state(
        tstate, jnp_tree(jstate.params), jnp_tree(jstate.target_params),
        jnp_tree(adam.mu), jnp_tree(adam.nu), int(adam.count),
        float(jdqn.current_lr(jstate)), int(jstate.step_counter),
        int(jstate.train_steps))
    return tstate


def both_states(seed=0, tie_free_head=False, **over):
    cfg = dict(NARROW, **over)
    jcfg, tcfg = jdqn.DQNConfig(**cfg), tdqn.DQNConfig(**cfg)
    model, js = jdqn.create_train_state(jcfg, jax.random.PRNGKey(seed))
    if tie_free_head:
        params = jax.tree.map(jnp.asarray, tie_free(js.params, seed))
        js = js.replace(params=params, target_params=params,
                        opt_state=jdqn.make_optimizer(jcfg).init(params))
    ts = carry(js, tdqn.create_train_state(tcfg, "cpu", seed))
    return jcfg, tcfg, model, js, ts


def random_boards(rng, n, dead=0):
    b = rng.integers(0, 11, (n, 4, 4))
    b[rng.random((n, 4, 4)) < 0.35] = 0
    # Dead boards: a checkerboard of 1s and 2s has no legal move.
    b[:dead] = 1 + (np.arange(16).reshape(4, 4) + np.arange(4)[:, None]) % 2
    return b.astype(np.int8)


def batch_of(rng, n):
    return {
        "board": random_boards(rng, n),
        "action": rng.integers(0, 4, n).astype(np.int32),
        "reward": rng.choice([-10, 0, 4, 8, 16, 50], n).astype(np.float32),
        "done": rng.random(n) < 0.2,
        "next_board": random_boards(rng, n),
    }


def to_torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out["action"] = out["action"].to(torch.int64)
    return out


def assert_rel(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{name}: {err.max():.3e} > {tol}"


def torch_layout(ts, tree):
    """A flax-layout tree of JAX's (params, gradients, moments) as
    ``{state-dict name: numpy array}`` in the port's layout."""
    return {n: t.numpy() for n, t in tmodels.flax_to_torch_layout(
        ts.model, jax.tree.map(np.asarray, tree)).items()}


def test_select_actions_bit_exact_on_jax_draws():
    _, _, model, js, ts = both_states(1, tie_free_head=True)
    rng = np.random.default_rng(1)
    boards = random_boards(rng, 256, dead=8)
    legal = np.array(jboard.legal_moves_mask(jnp.asarray(boards)))
    assert not legal[:8].any() and legal[8:].any(-1).all()
    restrict = rng.random(256) < 0.5
    for i, eps in enumerate((0.0, 0.3, 1.0)):
        key = jax.random.PRNGKey(10 + i)
        want = jdqn.select_actions(model, js.params, jnp.asarray(boards),
                                   jnp.asarray(legal), jnp.asarray(restrict),
                                   eps, key)
        k_explore, k_rand, k_rand_legal = jax.random.split(key, 3)
        draws = tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.uniform(k_explore, (256,)),
            jax.random.randint(k_rand, (256,), 0, 4),
            jax.random.uniform(k_rand_legal, (256,))))
        got = tdqn.select_actions(ts.model, torch.from_numpy(boards),
                                  torch.from_numpy(legal),
                                  torch.from_numpy(restrict), eps, draws)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if eps == 1.0:  # every restricted lane with a move picks a legal one
            ok = legal[np.arange(256), got.numpy()]
            assert ok[restrict & legal.any(-1)].all()


def test_dqn_targets_and_q_match():
    jcfg, tcfg, model, js, ts = both_states(2)
    rng = np.random.default_rng(2)
    batch = batch_of(rng, 64)
    want = jdqn.dqn_targets(jcfg, model, js.target_params,
                            jax.tree.map(jnp.asarray, batch))
    got = tdqn.dqn_targets(tcfg, ts.target, to_torch_batch(batch))
    assert_rel(got.numpy(), want, RTOL, "targets")


def test_dedup_mask_over_a_trajectory_bit_exact():
    rng = np.random.default_rng(3)
    b, steps = 16, 40
    jd, td = jdqn.dedup_init(b), tdqn.dedup_init(b)
    hist = []
    skips = 0
    for t in range(steps):
        boards = random_boards(rng, b)
        nxt = random_boards(rng, b)
        if len(hist) >= 2:
            # Half the lanes repeat their (s, s') from two steps back, so
            # the 2-back rule has matches to skip.
            rep = rng.random(b) < 0.5
            boards[rep] = hist[-2][0][rep]
            nxt[rep] = hist[-2][1][rep]
        dones = rng.random(b) < 0.1
        hist.append((boards, nxt))
        jsave, jd = jdqn.dedup_mask(jd, jnp.asarray(boards), jnp.asarray(nxt),
                                    jnp.asarray(dones))
        tsave, td = tdqn.dedup_mask(td, torch.from_numpy(boards),
                                    torch.from_numpy(nxt),
                                    torch.from_numpy(dones))
        np.testing.assert_array_equal(tsave.numpy(), np.asarray(jsave))
        for name in ("s", "ns", "saved_count", "last_saved"):
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)))
        skips += int((~tsave).sum())
    assert skips > 20
    off, _ = tdqn.dedup_mask(td, torch.from_numpy(boards),
                             torch.from_numpy(nxt), torch.from_numpy(dones),
                             enabled=False)
    assert off.all()


def test_epsilon_schedule_matches_jax_float32():
    cfg, jcfg = tdqn.DQNConfig(), jdqn.DQNConfig()
    for steps in (0, 1, 128, 12_800, 65_536, 1_000_003, 2**24 + 1, 10**8):
        got = tdqn.epsilon_value(cfg, steps)
        want = jdqn.epsilon_value(jcfg, jnp.int32(steps))
        assert np.float32(got) == np.asarray(want), steps
        assert got == float(np.float32(got))


def test_lr_decay_matches_jax_float32():
    jcfg, tcfg, _, js, ts = both_states(4)
    for i in range(50):
        js = jdqn.maybe_decay_lr(jcfg, js, 1)
        tdqn.maybe_decay_lr(tcfg, ts, 1)
        assert tdqn.current_lr(ts) == float(jdqn.current_lr(js)), i
    for n in (0, 3, 0, 200):  # pass-through, a multi-episode step, clamp
        js = jdqn.maybe_decay_lr(jcfg, js, n)
        tdqn.maybe_decay_lr(tcfg, ts, n)
        assert tdqn.current_lr(ts) == float(jdqn.current_lr(js)), n
    assert tdqn.current_lr(ts) == float(np.float32(1e-6))
    # With zero triggers an LR below lr_min is not raised to the floor.
    tdqn.set_lr(ts, 1e-7)
    tdqn.maybe_decay_lr(tcfg, ts, 0)
    assert tdqn.current_lr(ts) == float(np.float32(1e-7))


def jax_grads(jcfg, model, js, batch):
    targets = jdqn.dqn_targets(jcfg, model, js.target_params, batch)

    def loss_fn(params):
        q = model.apply({"params": params}, batch["board"], train=False)
        q_taken = jnp.take_along_axis(q, batch["action"][:, None], -1)[:, 0]
        return jnp.mean((targets - q_taken) ** 2) / 4

    return jax.grad(loss_fn)(js.params)


def test_train_step_matches_jax():
    jcfg, tcfg, model, js, ts = both_states(5)
    tx = jdqn.make_optimizer(jcfg)
    step = jax.jit(lambda s, b: jdqn.train_step(jcfg, model, tx, s, b))
    rng = np.random.default_rng(5)
    noisy_total = n_total = 0
    for t in range(3):
        batch = batch_of(rng, B)
        jbatch = jax.tree.map(jnp.asarray, batch)
        grads = jax_grads(jcfg, model, js, jbatch)
        js, metrics = step(js, jbatch)
        loss, td = tdqn.train_step(tcfg, ts, to_torch_batch(batch))
        assert_rel(float(loss), metrics["loss"], RTOL, "loss")
        assert_rel(td.numpy(), metrics["td_errors"], RTOL, "|TD|")
        assert ts.train_steps == int(js.train_steps) == t + 1

        named = dict(ts.model.named_parameters())
        noisy = {}
        for name, g in torch_layout(ts, grads).items():
            tg = named[name].grad.numpy()
            scale = max(np.abs(g).max(), 1e-30)
            err = np.abs(tg - g).max() / scale
            assert err <= GRAD_TOL, f"grad {name}: {err:.3e}"
            # Noise level, unless both sides give exactly 0 (dead units,
            # one-hot channels no board sets): Adam moves neither then.
            noisy[name] = (np.abs(g) <= GRAD_TOL * scale) & ~((g == 0)
                                                             & (tg == 0))

        adam = js.opt_state.inner_state[0]
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for name, want in torch_layout(ts, tree).items():
                got = ts.optimizer.state[named[name]][key].numpy()
                assert_rel(got, want, RTOL, f"{key} {name}")
        lr = tdqn.current_lr(ts)
        for name, want in torch_layout(ts, js.params).items():
            err = np.abs(named[name].detach().numpy() - want)
            fine = ~noisy[name]
            assert err[fine].max(initial=0) <= PARAM_ATOL, f"param {name}"
            assert err[~fine].max(initial=0) <= 2 * lr * (t + 1)
            noisy_total += int((~fine).sum())
            n_total += err.size
    # The noise-level gradients are a small share of the elements.
    assert noisy_total <= n_total // 1000


def test_update_target_copies_the_online_network():
    jcfg, tcfg, _, js, ts = both_states(6)
    batch = to_torch_batch(batch_of(np.random.default_rng(6), B))
    tdqn.train_step(tcfg, ts, batch)
    w = ts.model.head.weight
    assert not torch.equal(ts.target.head.weight, w)
    tdqn.update_target(ts)
    for t, p in zip(ts.target.parameters(), ts.model.parameters()):
        assert torch.equal(t, p) and not t.requires_grad


def test_dropout_keep_rate_and_scale():
    cfg = tdqn.DQNConfig(features=8, hidden=512, num_blocks=1, bf16=False,
                         dropout=0.5)
    model = tmodels.init_params(tmodels.create_model(cfg, "cpu"),
                                torch.Generator().manual_seed(0))
    boards = torch.from_numpy(random_boards(np.random.default_rng(7), 64))
    hidden = {}
    model.head.register_forward_hook(
        lambda mod, inp, out: hidden.__setitem__("x", inp[0].detach()))
    model.eval()
    with torch.no_grad():
        q_eval = model(boards)
    full = hidden["x"]
    model.train()
    with torch.no_grad():
        q_train = model(boards, generator=torch.Generator().manual_seed(3))
    kept = hidden["x"]
    mask = torch.rand(full.shape, generator=torch.Generator().manual_seed(3)
                      ) < 0.5
    # Kept units are scaled by exactly 1 / (1 - rate) = 2, the rest are 0.
    torch.testing.assert_close(kept, torch.where(mask, full * 2, 0.0),
                               rtol=0, atol=0)
    active = full > 0
    rate = float((kept[active] != 0).to(torch.float32).mean())
    assert 0.47 < rate < 0.53
    assert not torch.equal(q_train, q_eval)
    with pytest.raises(ValueError, match="generator"):
        model(boards)
    # Rate 0 and eval mode return the input unchanged, as flax's Dropout.
    model.dropout_rate = 0.0
    with torch.no_grad():
        torch.testing.assert_close(model(boards), q_eval, rtol=0, atol=0)


def test_bf16_gradients_reach_the_float32_parameters():
    cfg = tdqn.DQNConfig(features=32, hidden=16, num_blocks=2, bf16=True,
                         dropout=0.5)
    ts = tdqn.create_train_state(cfg, "cpu", 0)
    before = [p.detach().clone() for p in ts.model.parameters()]
    loss, td = tdqn.train_step(cfg, ts, to_torch_batch(
        batch_of(np.random.default_rng(8), B)))
    assert torch.isfinite(loss) and td.shape == (B,)
    for p, b in zip(ts.model.parameters(), before):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all() and not torch.equal(p, b)
