"""The port's shaped fast env against JAX ``fast_step`` (shaped, lax
backend) on the same bits.

Each step the port replays the bits JAX draws,
``jax.random.bits(fold_in(PRNGKey(2048), state.seed), (8, B))``. The
actions repeat with p = 0.85, so stall penalties and stall-forced episode
ends fire (tight stall knobs, as tests/test_fast_shaped.py uses). Boards,
dones, scores, validity, the stall lanes and ``prev_max`` must be equal;
rewards within the shaped reward's float32 tolerance (test_torch_rewards.py)
and returns within it times the episode's steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.env import fast as jfast
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import EnvConfig

B, STEPS = 64, 40
REWARD_RTOL = 2e-6  # of max(1, |r|), as in test_torch_rewards.py
EXACT = ("boards", "legal", "score", "episode_steps", "prev_max",
         "consec_action", "consec_count", "last_consec_penalty")


def to_torch(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def port_state(js):
    return tfast.ShapedFastEnvState(
        **{name: to_torch(getattr(js, name)) for name in
           EXACT + ("episode_return",)})


def jax_bits(state):
    key = jax.random.fold_in(jax.random.PRNGKey(2048), state.seed)
    return jax.random.bits(key, (8, state.boards.shape[1]), jnp.uint32)


def assert_close(got, want, scale, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype, name
    tol = REWARD_RTOL * np.maximum(1.0, np.abs(want)) * scale
    assert (np.abs(got - want) <= tol).all(), name


@pytest.mark.parametrize("reset_shaping", [False, True])
def test_shaped_fast_step_matches_jax(reset_shaping):
    env = EnvConfig(reward="shaped", max_consecutive_actions=3,
                    stall_force_done=9, reset_shaping_on_reset=reset_shaping)
    tcfg = tfast.for_env(env)
    assert tcfg.shaped and tcfg.stall_force_done == 9
    jcfg = jfast.FastEnvConfig(
        shaped=True, interpret=True, external_rng=True, backend="lax",
        max_consecutive_actions=3, stall_force_done=9,
        reset_shaping=reset_shaping)
    js = jfast.fast_reset(jcfg, jax.random.PRNGKey(5), B)
    ts = port_state(js)
    jstep = jax.jit(jfast.fast_step, static_argnums=(0,),
                    static_argnames=("need_obs", "need_legal"))
    rng = np.random.default_rng(6)
    actions = rng.integers(0, 4, B).astype(np.int32)
    forced = stalled = dones = 0
    for t in range(STEPS):
        repeat = rng.random(B) < 0.85
        actions = np.where(repeat, actions,
                           rng.integers(0, 4, B)).astype(np.int32)
        need_legal = t % 4 != 3
        bits = tfast.ReplayBits([to_torch(jax_bits(js))])
        js, jts = jstep(jcfg, js, jnp.asarray(actions), need_obs=True,
                        need_legal=need_legal)
        ts, tts = tfast.fast_step(tcfg, ts, bits, torch.from_numpy(actions),
                                  need_obs=True, need_legal=need_legal)
        for name in EXACT:
            got, want = getattr(ts, name).numpy(), np.asarray(getattr(js,
                                                                      name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=f"{name} @ {t}")
        for name in ("obs", "done", "valid", "merge_score", "max_number",
                     "episode_steps"):
            np.testing.assert_array_equal(
                getattr(tts, name).numpy(), np.asarray(getattr(jts, name)),
                err_msg=f"{name} @ {t}")
        assert_close(tts.reward.numpy(), jts.reward, 1, f"reward @ {t}")
        steps = tts.episode_steps.numpy()
        assert_close(tts.episode_return.numpy(), jts.episode_return, steps,
                     f"episode_return @ {t}")
        assert_close(ts.episode_return.numpy(), js.episode_return, steps,
                     f"state episode_return @ {t}")
        # A valid move ends an episode only by the stall force-done.
        forced += int((tts.done & tts.valid).numpy().sum())
        stalled += int((ts.consec_count.numpy() > 3).sum())
        dones += int(tts.done.numpy().sum())
    assert forced and stalled and dones
