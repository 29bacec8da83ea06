"""The port's replay buffer against ``tpu2048.replay.buffer`` on the same
numpy-seeded transitions.

Integer-valued state is held bit for bit: every slot array, ``ptr``,
``size`` and ``max_priority`` after adds (with masks, across the ring's
wrap), priority updates, peeks and prunes (with tied episode scores), and
every batch field sampled at the indices JAX's key draws. Only PER's
importance weights go through float32 sums whose order differs (the
probabilities' normalizer): they are held to ``W_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.replay import buffer as jbuf
from tpu2048_torch.replay import buffer as tbuf

C = 64
W_RTOL = 1e-5  # PER weights: a float32 sum of C terms in another order
FIELDS = ("boards", "next_boards", "actions", "rewards", "dones",
          "priorities")
BATCH_KEYS = ("board", "action", "reward", "done", "next_board")


def transitions(rng, n, done_rate=0.15, reward_values=None):
    """n transitions: int8 boards, actions, integer-valued rewards of the
    simple env (merge scores, -10 for a stall, +50/+100 bonuses)."""
    boards = rng.integers(0, 12, (n, 4, 4)).astype(np.int8)
    next_boards = rng.integers(0, 12, (n, 4, 4)).astype(np.int8)
    actions = rng.integers(0, 4, n).astype(np.int32)
    if reward_values is None:
        reward_values = [-10, 0, 4, 8, 16, 32, 50, 100]
    rewards = rng.choice(reward_values, n).astype(np.float32)
    dones = rng.random(n) < done_rate
    return boards, actions, rewards, dones, next_boards


def add_both(jb, tb, tr, mask):
    jb = jax.jit(jbuf.replay_add)(jb, *map(jnp.asarray, tr),
                                  jnp.asarray(mask))
    tbuf.replay_add(tb, *map(torch.from_numpy, tr), torch.from_numpy(mask))
    return jb, tb


def assert_buffers_equal(tb, jb):
    assert tb.capacity == jb.capacity
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy()[:C],
                                      np.asarray(getattr(jb, name)), name)
    for name in ("ptr", "size", "max_priority"):
        assert getattr(tb, name).item() == getattr(jb, name).item(), name
        assert getattr(tb, name).dtype == {
            "ptr": torch.int32, "size": torch.int32,
            "max_priority": torch.float32}[name]


def filled(seed, n_adds=6, b=24, done_rate=0.15, reward_values=None):
    """Both buffers after ``n_adds`` masked adds of ``b`` (past the ring's
    wrap), a priority update between them raising ``max_priority``."""
    rng = np.random.default_rng(seed)
    jb, tb = jbuf.replay_init(C), tbuf.replay_init(C)
    for i in range(n_adds):
        tr = transitions(rng, b, done_rate, reward_values)
        mask = rng.random(b) < 0.7
        jb, tb = add_both(jb, tb, tr, mask)
        assert_buffers_equal(tb, jb)
        if i == 2:
            idx = rng.choice(int(jb.size), 8, replace=False)
            td = (rng.standard_normal(8) * 3).astype(np.float32)
            jb = jbuf.replay_update_priorities(jb, jnp.asarray(idx),
                                               jnp.asarray(td))
            tbuf.replay_update_priorities(tb, torch.from_numpy(idx),
                                          torch.from_numpy(td))
            assert_buffers_equal(tb, jb)
    return jb, tb


def episode_scores(tb):
    """Scores of the complete episodes, oldest first (numpy oracle)."""
    size, ptr = int(tb.size), int(tb.ptr)
    phys = (ptr - size + np.arange(size)) % C
    scores, acc = [], 0.0
    for r, d in zip(tb.rewards.numpy()[phys], tb.dones.numpy()[phys]):
        acc += max(float(r), 0.0)
        if d:
            scores.append(acc)
            acc = 0.0
    return scores


def test_add_with_masks_wraps_the_ring_bit_exact():
    jb, tb = filled(0)
    assert int(tb.size) == C and float(tb.max_priority) > 1.0
    # Wrapped: more was accepted than fits, and ptr is mid-ring.
    assert 0 < int(tb.ptr) < C
    # A fully masked add changes nothing; an empty-mask lane never writes.
    rng = np.random.default_rng(9)
    tr = transitions(rng, 8)
    jb, tb = add_both(jb, tb, tr, np.zeros(8, bool))
    assert_buffers_equal(tb, jb)


def test_partial_fill_and_peek():
    rng = np.random.default_rng(1)
    jb, tb = jbuf.replay_init(C), tbuf.replay_init(C)
    tr = transitions(rng, 20)
    jb, tb = add_both(jb, tb, tr, rng.random(20) < 0.5)
    assert_buffers_equal(tb, jb)
    jb, tb = filled(2)
    for back in range(4):
        want = jbuf.replay_peek(jb, back)
        got = tbuf.replay_peek(tb, back)
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          f"{k} back={back}")


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_sample_at_jax_indices(alpha):
    jb, tb = filled(3)
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        jbatch, jidx, jw = jbuf.replay_sample(jb, key, 32, alpha, 0.4)
        tbatch, tidx, tw = tbuf.replay_sample(
            tb, 32, alpha, 0.4, indices=torch.from_numpy(np.array(jidx)))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(tbatch[k].numpy(),
                                          np.asarray(jbatch[k]), k)
        if alpha == 0.0:
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        else:
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                       rtol=W_RTOL, atol=0)
    probs_t = tbuf._probabilities(tb, alpha).numpy()
    probs_j = np.asarray(jbuf._probabilities(jb, alpha))
    np.testing.assert_allclose(probs_t, probs_j, rtol=W_RTOL, atol=0)


def test_sample_before_the_buffer_fills():
    """Uniform indices stay under ``size``, and all-zero priorities fall
    back to uniform (Dqn8:75-83)."""
    rng = np.random.default_rng(4)
    jb, tb = jbuf.replay_init(C), tbuf.replay_init(C)
    jb, tb = add_both(jb, tb, transitions(rng, 10), np.ones(10, bool))
    tb.priorities.zero_()
    jb = jb.replace(priorities=jnp.zeros_like(jb.priorities))
    np.testing.assert_array_equal(tbuf._probabilities(tb, 0.6).numpy(),
                                  np.asarray(jbuf._probabilities(jb, 0.6)))
    gen = torch.Generator().manual_seed(0)
    idx = tbuf.sample_indices(tb, 4096, 0.0, gen)
    assert idx.dtype == torch.int64
    assert int(idx.min()) == 0 and int(idx.max()) == 9
    counts = torch.bincount(idx, minlength=10).numpy()
    assert counts.min() > 4096 / 10 * 0.8  # ~uniform


def test_generator_sampling_follows_priorities():
    jb, tb = filled(5)
    tb.priorities[:C] = 1e-3
    tb.priorities[7] = 10.0
    gen = torch.Generator().manual_seed(1)
    idx = tbuf.sample_indices(tb, 4096, 0.6, gen)
    # p(7) = 10**0.6 / (10**0.6 + 63 * 1e-3**0.6) ~ 0.76
    share = float((idx == 7).to(torch.float32).mean())
    assert 0.7 < share < 0.82
    _, _, w = tbuf.replay_sample(tb, 16, 0.6, 1.0,
                                 tbuf.sample_indices(tb, 16, 0.6, gen))
    assert float(w.max()) == 1.0


def test_update_priorities_bit_exact():
    jb, tb = filled(6)
    rng = np.random.default_rng(6)
    idx = rng.choice(C, 16, replace=False)
    td = (rng.standard_normal(16) * 50).astype(np.float32)
    jb = jbuf.replay_update_priorities(jb, jnp.asarray(idx), jnp.asarray(td),
                                       1e-6)
    tbuf.replay_update_priorities(tb, torch.from_numpy(idx),
                                  torch.from_numpy(td), 1e-6)
    assert_buffers_equal(tb, jb)


@pytest.mark.parametrize("n_remove", [1, 3, 10, 100])
def test_prune_with_tied_scores_bit_exact(n_remove):
    """Rewards from {0, 4}: many episodes tie on score, so the stable rank
    (older first) decides which go."""
    jb, tb = filled(7, n_adds=5, done_rate=0.3, reward_values=[0, 4])
    scores = episode_scores(tb)
    assert len(set(scores)) < len(scores)  # ties among complete episodes
    jp = jax.jit(jbuf.prune_low_score_episodes, static_argnums=1)(jb,
                                                                  n_remove)
    tp = tbuf.prune_low_score_episodes(tb, n_remove)
    assert_buffers_equal(tp, jp)
    assert int(tp.size) < int(tb.size)


def test_prune_before_the_wrap_keeps_the_partial_episode():
    rng = np.random.default_rng(8)
    jb, tb = jbuf.replay_init(C), tbuf.replay_init(C)
    tr = transitions(rng, 30, done_rate=0.2)
    jb, tb = add_both(jb, tb, tr, np.ones(30, bool))
    for n in (2, 50):
        assert_buffers_equal(tbuf.prune_low_score_episodes(tb, n),
                             jbuf.prune_low_score_episodes(jb, n))
