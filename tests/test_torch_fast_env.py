"""The port's fast env against JAX ``fast_step(backend="lax")``.

The port replays the bits JAX draws for each step,
``jax.random.bits(fold_in(PRNGKey(2048), state.seed), (8, B))``; rewards,
the terminal bonus and the episode lanes must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.env import fast as jfast
from tpu2048.ops import board as jboard
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.ops import board as tboard

B = 256


def to_torch(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def endgame_boards(seed, b):
    """Dense boards with one empty cell; a third hold a 2048 and a third two
    1024s, so games end with either terminal bonus within a few steps."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(1, 9, (b, 16))
    third = b // 3
    boards[:third, 5] = 11
    boards[third:2 * third, 0] = 10
    boards[third:2 * third, 15] = 10
    boards[np.arange(b), rng.integers(0, 16, b)] = 0
    return boards.reshape(b, 4, 4).astype(np.int8)


def jax_bits(state):
    key = jax.random.fold_in(jax.random.PRNGKey(2048), state.seed)
    return jax.random.bits(key, (8, state.boards.shape[1]), jnp.uint32)


def port_state(js):
    return tfast.FastEnvState(
        boards=to_torch(js.boards),
        legal=to_torch(js.legal),
        score=to_torch(js.score),
        episode_steps=to_torch(js.episode_steps),
        episode_return=to_torch(js.episode_return),
    )


def assert_state_equal(ts_state, js_state):
    for name in ("boards", "legal", "score", "episode_steps",
                 "episode_return"):
        got = getattr(ts_state, name).numpy()
        want = np.asarray(getattr(js_state, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("terminal_bonus", [True, False])
def test_fast_step_matches_jax_lax_backend(terminal_bonus):
    jcfg = jfast.FastEnvConfig(terminal_bonus=terminal_bonus,
                               interpret=True, external_rng=True,
                               backend="lax")
    tcfg = tfast.FastEnvConfig(terminal_bonus=terminal_bonus)
    js = jfast.fast_reset(jcfg, jax.random.PRNGKey(1), B)
    half = B // 2
    boards = np.asarray(jfast.ps.from_cell_major(js.boards)).copy()
    boards[half:] = endgame_boards(2, B - half)
    js = js.replace(boards=jfast.ps.to_cell_major(jnp.asarray(boards)),
                    legal=jboard.legal_moves_mask(jnp.asarray(boards)))
    ts = port_state(js)
    jstep = jax.jit(jfast.fast_step, static_argnums=(0,),
                    static_argnames=("need_obs", "need_legal"))
    rng = np.random.default_rng(3)
    bonus_50 = bonus_100 = 0
    for t in range(48):
        need_legal = t % 5 != 4  # a stale legal mask on some steps
        if t % 3 == 0:
            actions = None  # the kernel's random-legal policy
        else:
            actions = rng.integers(0, 4, B).astype(np.int32)
        bits = tfast.ReplayBits([to_torch(jax_bits(js))])
        js, jts = jstep(jcfg, js, None if actions is None else
                        jnp.asarray(actions), need_obs=True,
                        need_legal=need_legal)
        ts, tts = tfast.fast_step(
            tcfg, ts, bits, None if actions is None else to_torch(actions),
            need_obs=True, need_legal=need_legal)
        assert_state_equal(ts, js)
        for name in ("obs", "reward", "done", "valid", "merge_score",
                     "max_number", "episode_return", "episode_steps"):
            got, want = getattr(tts, name).numpy(), np.asarray(getattr(jts,
                                                                       name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=f"{name} @ {t}")
        done = tts.done.numpy()
        merge = tts.merge_score.numpy().astype(np.float32)
        extra = tts.reward.numpy() - merge
        bonus_100 += int((done & (extra == 100)).sum())
        bonus_50 += int((done & (extra == 50)).sum())
    if terminal_bonus:
        assert bonus_100 > 0 and bonus_50 > 0
    else:
        assert bonus_100 == bonus_50 == 0


def test_reset_distribution():
    n = 20000
    state = tfast.fast_reset(tfast.GeneratorBits(0, "cpu"), n)
    boards = state.boards.T.numpy()  # (n, 16)
    assert ((boards != 0).sum(-1) == 2).all()
    tiles = boards[boards != 0]
    assert set(np.unique(tiles)) <= {1, 2}
    share_4 = (tiles == 2).mean()
    assert abs(share_4 - 0.1) < 0.01
    per_cell = (boards != 0).sum(0)
    assert np.all(np.abs(per_cell - 2 * n / 16) < 0.1 * 2 * n / 16)
    np.testing.assert_array_equal(
        state.legal.numpy(),
        tboard.legal_moves_mask(state.boards.T.reshape(n, 4, 4)).numpy())

    # init_board's distribution, which the JAX fast_reset draws from.
    jboards = np.asarray(jax.vmap(jboard.init_board)(
        jax.random.split(jax.random.PRNGKey(0), n))).reshape(n, 16)
    jtiles = jboards[jboards != 0]
    assert abs((jtiles == 2).mean() - share_4) < 0.015


def test_generator_bits_cover_the_range_and_repeat():
    a = tfast.GeneratorBits(7, "cpu")(4096)
    b = tfast.GeneratorBits(7, "cpu")(4096)
    assert a.shape == (8, 4096) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert (a < 0).any() and (a > 0).any()


def test_replay_bits_check_the_shape():
    bits = tfast.ReplayBits([torch.zeros((8, 4), dtype=torch.int32)])
    with pytest.raises(ValueError):
        bits(5)


def test_shaped_mode_is_not_yet_ported():
    """Shaped mode runs explicit actions only: its random-policy runs need
    the rollout kernel, which the port does not have yet."""
    cfg = tfast.FastEnvConfig(shaped=True)
    bits = tfast.GeneratorBits(0, "cpu")
    state = tfast.fast_reset(bits, 8, cfg)
    assert isinstance(state, tfast.ShapedFastEnvState)
    with pytest.raises(ValueError, match="explicit actions"):
        tfast.fast_step(cfg, state, bits, None)
