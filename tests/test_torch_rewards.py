"""The port's rewards against :mod:`tpu2048.env.rewards`.

The shaped reward takes ``log2`` and ``level ** 1.2`` in float32, which
torch and XLA's CPU library may round one ulp apart, so it is held to
``2e-6 * max(1, |r|)``; the new running max, the simple reward, the
terminal bonus and the top-two tiles are exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import torch

from tpu2048.env import rewards as jrw
from tpu2048_torch.env import rewards as trw

REWARD_RTOL = 2e-6  # of max(1, |r|): one float32 ulp of log2 / pow, twice


def assert_reward_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    tol = REWARD_RTOL * np.maximum(1.0, np.abs(want))
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-30)


def test_shaped_reward_on_every_edge_case():
    tiles = [0] + [1 << e for e in range(1, 13)]  # 0, 2 .. 4096
    prevs = [1] + [1 << e for e in range(1, 12)]
    scores = [0, 4, 8, 100, 2048, 20000]
    cases = np.array(list(itertools.product(tiles, prevs, (False, True),
                                            (False, True), scores)))
    max_number, prev_max, valid, game_over, score = (
        cases[:, i] for i in range(5))
    args = (score.astype(np.int32), valid.astype(bool),
            game_over.astype(bool), max_number.astype(np.int32),
            prev_max.astype(np.int32))
    j_r, j_prev = jrw.shaped_reward(*map(jnp.asarray, args))
    t_r, t_prev = trw.shaped_reward(*map(torch.from_numpy, args))
    assert_reward_close(t_r.numpy(), j_r)
    np.testing.assert_array_equal(t_prev.numpy(), np.asarray(j_prev))
    assert t_prev.dtype == torch.int32
    # The edge cases are all there: milestone terminal moves, progress.
    milestone = np.isin(max_number, [512, 1024, 2048])
    assert (milestone & ~args[1] & args[2]).any()
    assert (max_number > prev_max).any() and (max_number <= prev_max).any()
    assert (np.asarray(j_r) < 0).any() and (np.asarray(j_r) > 0).any()


def test_normalize_reward():
    rng = np.random.default_rng(0)
    r = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, 1023.0, 1024.0, -2000.0, 1e6],
                 np.float32),
        (rng.normal(size=512) * 10.0 ** rng.uniform(-3, 5, 512)).astype(
            np.float32),
    ])
    assert_reward_close(trw.normalize_reward(torch.from_numpy(r)).numpy(),
                        jrw.normalize_reward(jnp.asarray(r)))


def test_simple_reward_terminal_bonus_and_top2_are_exact():
    rng = np.random.default_rng(1)
    b = 256
    score = rng.integers(0, 5000, b).astype(np.int32)
    valid = rng.random(b) < 0.5
    over = rng.random(b) < 0.5
    np.testing.assert_array_equal(
        trw.simple_reward(*map(torch.from_numpy, (score, valid, over))),
        np.asarray(jrw.simple_reward(*map(jnp.asarray,
                                          (score, valid, over)))))

    boards = rng.integers(0, 12, (b, 4, 4)).astype(np.int8)
    boards[:32, 0, 0] = boards[:32, 3, 3] = 10  # two 1024s
    boards[32:64, 1, 2] = 11  # a 2048
    boards[64] = 0
    t_top2 = trw.top2_tile_values(torch.from_numpy(boards))
    j_top2 = jrw.top2_tile_values(jnp.asarray(boards))
    np.testing.assert_array_equal(t_top2.numpy(), np.asarray(j_top2))
    done = rng.random(b) < 0.7
    t_bonus = trw.terminal_bonus(t_top2, torch.from_numpy(done))
    j_bonus = jrw.terminal_bonus(j_top2, jnp.asarray(done))
    np.testing.assert_array_equal(t_bonus.numpy(), np.asarray(j_bonus))
    assert {0.0, 50.0, 100.0} <= set(t_bonus.numpy().tolist())
