"""The classic env of the port (``tpu2048_torch.env.env`` and the spawn ops
of ``tpu2048_torch.ops.board``) against ``tpu2048.env.env`` on the same
inputs, made with numpy from a seed.

Integers (boards, scores, dones, legal masks, maxima, step counts, stall
counters) must be equal. The simple reward and the terminal bonus are
integers in float32 and must be equal too; the shaped reward's log2 and
pow may round one float32 ulp apart (test_torch_rewards.py), so shaped
rewards are held to ``REWARD_RTOL`` of max(1, |r|) and the episode returns
that sum them to ``RETURN_RTOL``.

JAX keys each lane's spawn by its own key leaf; the port takes a draw
source. ``JaxKeyChain`` is a draw source that computes JAX's chain (a split
a lane a step, ``sample_spawn`` on the board the tile lands on, ``fold_in(k,
1)`` for the auto-reset's board), so the port's ``reset``/``step`` must
follow JAX's trajectory exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fast_env import endgame_boards
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.env import env as jenv
from tpu2048.ops import board as jboard
from tpu2048_torch.env import env as tenv
from tpu2048_torch.ops import board as tboard

B, STEPS, SEED = 64, 32, 14
REWARD_RTOL = 2e-6  # of max(1, |r|), as in test_torch_rewards.py
RETURN_RTOL = 2e-5  # of max(1, |r|): STEPS rewards summed in float32
# Each mode of the env; the shaped ones with short stall limits, so that
# stall penalties and the stall force-done happen within STEPS.
STALL = dict(max_consecutive_actions=3, stall_force_done=8)
MODES = {
    "simple": dict(reward="simple"),
    "simple-bonus": dict(reward="simple", terminal_bonus=True),
    "simple-quirk": dict(reward="simple", quirk_compat=True),
    "shaped": dict(reward="shaped", **STALL),
    "shaped-reset-shaping": dict(reward="shaped", reset_shaping_on_reset=True,
                                 **STALL),
}
# Full but playable: every row merges left, so the quirk probe (LEFT) leaves
# 8 empties in columns 2-3 (tests/test_env.py:208-235).
CLOBBER = [[2, 2, 4, 4], [8, 8, 16, 16], [32, 32, 64, 64], [128, 128, 2, 2]]
DEAD = [[2, 4, 2, 4], [4, 2, 4, 2], [2, 4, 2, 4], [4, 2, 4, 2]]
INTS = ("board", "score", "move_score", "prev_max", "consec_action",
        "consec_count", "episode_steps", "done")
TS_INTS = ("obs", "done", "max_number", "valid", "merge_score", "legal_mask",
           "episode_steps")


def configs(mode, **over):
    kw = dict(MODES[mode], **over)
    return jenv.EnvConfig(**kw), tenv.EnvConfig(**kw)


def exps(values):
    return np.asarray(jboard.values_to_exponents(jnp.asarray(values)))


def start_boards(seed, b=B):
    """Mid-game boards, dense endgame boards (a third with a 2048, a third
    with two 1024s), the quirk clobber board, a dead board and a full board
    whose only moves are merges."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 7, (b, 4, 4)).astype(np.int8)
    boards[rng.random((b, 4, 4)) < 0.4] = 0
    boards[b // 4:b // 2] = endgame_boards(seed, b // 4)
    boards[b // 2] = exps(CLOBBER)
    boards[b // 2 + 1] = exps(DEAD)
    boards[b // 2 + 2] = exps([[2, 4, 8, 16], [4, 8, 16, 32],
                               [8, 16, 32, 64], [16, 32, 64, 64]])
    return boards


def port_state(js):
    """The port's EnvState with the values of JAX's (its rng leaf has no
    field here)."""
    return tenv.EnvState(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))
        for f in dataclasses.fields(tenv.EnvState)})


def jax_start(jcfg, boards, key=0):
    js = jenv.reset(jcfg, jax.random.PRNGKey(key), boards.shape[0])
    return js.replace(board=jnp.asarray(boards))


def assert_states(ts_state, js, shaped, name):
    for f in INTS:
        np.testing.assert_array_equal(getattr(ts_state, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      f"{name}: {f}")
    np.testing.assert_array_equal(ts_state.last_consec_penalty.numpy(),
                                  np.asarray(js.last_consec_penalty), name)
    assert_floats(ts_state.episode_return, js.episode_return,
                  RETURN_RTOL if shaped else 0.0, f"{name}: return")


def assert_floats(got, want, rtol, name):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max(initial=0.0) <= rtol, f"{name}: {err.max():.3e}"


def assert_timesteps(tts, jts, shaped, name):
    for f in TS_INTS:
        np.testing.assert_array_equal(getattr(tts, f).numpy(),
                                      np.asarray(getattr(jts, f)),
                                      f"{name}: {f}")
    assert tts.obs.dtype == torch.int8 and tts.reward.dtype == torch.float32
    assert_floats(tts.reward, jts.reward, REWARD_RTOL if shaped else 0.0,
                  f"{name}: reward")


# ---------------------------------------------------------------------------
# Board ops
# ---------------------------------------------------------------------------


def test_spawn_ops_match_jax_on_the_same_decisions():
    rng = np.random.default_rng(SEED)
    boards = start_boards(SEED, 256)
    boards[-1] = exps(DEAD)  # full: no empty cell
    tb = torch.from_numpy(boards)
    pos_u = torch.from_numpy(rng.random(256, np.float32))
    val_u = torch.from_numpy(rng.random(256, np.float32))
    idx, val = tboard.sample_spawn(tb, pos_u, val_u)
    n_empty = (boards == 0).reshape(256, 16).sum(-1)
    np.testing.assert_array_equal(
        idx.numpy(), np.floor(pos_u.numpy() * np.maximum(n_empty, 1)))
    np.testing.assert_array_equal(val.numpy(),
                                  np.where(val_u.numpy() < 0.9, 1, 2))
    assert idx.dtype == torch.int32 and val.dtype == torch.int8
    assert int(idx[-1]) == 0
    want = jax.vmap(jboard.spawn_at)(jnp.asarray(boards),
                                     jnp.asarray(idx.numpy()),
                                     jnp.asarray(val.numpy()))
    got = tboard.spawn_random_tile(tb, pos_u, val_u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[-1].numpy(), boards[-1])

    # Two spawns on an empty board, the second on the first's result.
    u = torch.from_numpy(rng.random((4, 256), np.float32))
    fresh = tboard.init_board(u[:2], u[2:])
    zeros = torch.zeros((256, 4, 4), dtype=torch.int8)
    first = tboard.spawn_random_tile(zeros, u[0], u[2])
    i1, v1 = tboard.sample_spawn(zeros, u[0], u[2])
    i2, v2 = tboard.sample_spawn(first, u[1], u[3])
    spawn = jax.vmap(jboard.spawn_at)
    want = spawn(spawn(jnp.zeros((256, 4, 4), jnp.int8),
                       jnp.asarray(i1.numpy()), jnp.asarray(v1.numpy())),
                 jnp.asarray(i2.numpy()), jnp.asarray(v2.numpy()))
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(want))
    assert ((fresh.numpy() != 0).reshape(256, 16).sum(-1) == 2).all()


def test_board_values_and_exponents_match_jax():
    """Up to 2**14; at 2**15 JAX's float32 log2 on the CPU rounds below 15
    and its exponent comes out 14, where the port's is exact."""
    boards = start_boards(SEED + 1, 256)
    boards[0, 0, 0] = 14
    got = tboard.board_values(torch.from_numpy(boards))
    want = jboard.board_values(jnp.asarray(boards))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    back = tboard.values_to_exponents(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jboard.values_to_exponents(want)))
    np.testing.assert_array_equal(back.numpy(), boards)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(
        tboard.values_to_exponents(np.asarray(CLOBBER)).numpy(),
        exps(CLOBBER))
    top = np.array([2 ** e for e in range(16)])
    np.testing.assert_array_equal(tboard.values_to_exponents(top).numpy(),
                                  np.arange(16))


# ---------------------------------------------------------------------------
# step_with_spawn in every mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_step_with_spawn_matches_jax(mode):
    jcfg, tcfg = configs(mode, auto_reset=False)
    shaped = jcfg.reward == "shaped"
    rng = np.random.default_rng(SEED)
    boards = start_boards(SEED)
    js = jax_start(jcfg, boards)
    ts_state = port_state(js)
    jstep = jax.jit(lambda s, a, i, v: jenv.step_with_spawn(jcfg, s, a, i, v))
    for t in range(STEPS):
        # Runs of one action, so that the stall counters climb; the first
        # step plays UP, illegal on the clobber board.
        actions = np.where(rng.random(B) < 0.7, t // 4 % 4,
                           rng.integers(0, 4, B)).astype(np.int32)
        if t == 0:
            actions[:] = 1
        idx = rng.integers(0, 6, B).astype(np.int32)
        val = rng.integers(1, 3, B).astype(np.int8)
        js, jts = jstep(js, jnp.asarray(actions), jnp.asarray(idx),
                        jnp.asarray(val))
        ts_state, tts = tenv.step_with_spawn(
            tcfg, ts_state, torch.from_numpy(actions), torch.from_numpy(idx),
            torch.from_numpy(val))
        assert_timesteps(tts, jts, shaped, f"{mode} step {t}")
        assert_states(ts_state, js, shaped, f"{mode} step {t}")
    done = np.asarray(js.done)
    assert done.any() and not done.all()
    if shaped:
        assert (np.asarray(js.consec_count) > STALL["max_consecutive_actions"]
                ).any()


def test_quirk_clobber_spawns_on_the_probe_board():
    """The quirk step of tests/test_env.py:182-205: UP is illegal on the
    clobber board, so the first legal probe (LEFT) is returned with the
    spawn on one of its empties; a dead board reports done before the
    move. (The trajectories above hold the same step against JAX.)"""
    _, tcfg = configs("simple-quirk", auto_reset=False)
    source = tenv.ReplaySpawns([], [torch.from_numpy(
        np.stack([exps(CLOBBER), exps(DEAD)]))])
    state = tenv.reset(tcfg, source, 2)
    state, ts = tenv.step_with_spawn(
        tcfg, state, torch.tensor([1, 1]), torch.tensor([5, 0]),
        torch.tensor([2, 1], dtype=torch.int8))
    out = tboard.board_values(ts.obs[0]).numpy()
    probe = np.array([[4, 8, 0, 0], [16, 32, 0, 0], [64, 128, 0, 0],
                      [256, 4, 0, 0]])
    probe[2, 3] = 4  # the sixth empty cell (row-major) gets a 4
    np.testing.assert_array_equal(out, probe)
    np.testing.assert_array_equal(ts.obs[1].numpy(), exps(DEAD))
    assert ts.done.tolist() == [False, True]
    assert ts.valid.tolist() == [False, False]
    # UP is invalid: -10 where the game goes on, 0 on the dead board.
    assert ts.reward.tolist() == [-10.0, 0.0]


# ---------------------------------------------------------------------------
# Whole trajectories on JAX's key chain
# ---------------------------------------------------------------------------


@jax.jit
def _chain_step(rng, board):
    """One step of JAX's per-lane chain (tpu2048/env/env.py:134-163)."""
    pairs = jax.vmap(lambda k: jax.random.split(k, 2))(rng)
    rng, step_keys = pairs[:, 0], pairs[:, 1]
    idx, val = jax.vmap(jboard.sample_spawn)(board, step_keys)
    fresh = jax.vmap(jboard.init_board)(
        jax.vmap(lambda k: jax.random.fold_in(k, 1))(step_keys))
    return rng, idx, val, fresh


@functools.partial(jax.jit, static_argnums=1)
def _chain_start(key, batch):
    """JAX's reset: the fresh boards and the lanes' key leaves."""
    k_boards, k_state = jax.random.split(key)
    boards = jax.vmap(jboard.init_board)(jax.random.split(k_boards, batch))
    return boards, jax.random.split(k_state, batch)


class JaxKeyChain:
    """A draw source that computes ``tpu2048.env.env``'s randomness: the
    reset's boards and key leaves from ``key``; a step splits each lane's
    key, draws the spawn from the board the port hands in, and keys the
    auto-reset's boards with ``fold_in(step_key, 1)``. It records what it
    handed out, for a replay."""

    def __init__(self, key, batch):
        self._next_fresh, self.rng = _chain_start(key, batch)
        self.spawns, self.fresh_boards = [], []

    def spawn(self, board):
        self.rng, idx, val, self._next_fresh = _chain_step(
            self.rng, jnp.asarray(board.numpy()))
        out = (torch.from_numpy(np.array(idx)),
               torch.from_numpy(np.array(val)))
        self.spawns.append(out)
        return out

    def fresh(self, batch):
        out = torch.from_numpy(np.array(self._next_fresh))
        self.fresh_boards.append(out)
        return out


@pytest.mark.parametrize("mode", list(MODES))
def test_reset_and_step_follow_jax_key_chain(mode):
    jcfg, tcfg = configs(mode)
    shaped = jcfg.reward == "shaped"
    key = jax.random.PRNGKey(SEED)
    chain = JaxKeyChain(key, B)
    js = jenv.reset(jcfg, key, B)
    ts_state = tenv.reset(tcfg, chain, B)
    assert_states(ts_state, js, shaped, f"{mode} reset")
    # Half the lanes on endgame boards and one on the clobber board, so
    # that episodes end and restart within the steps.
    late = np.array(js.board)
    late[B // 2:] = endgame_boards(SEED, B - B // 2)
    late[B // 2] = exps(CLOBBER)
    js = js.replace(board=jnp.asarray(late))
    ts_state.board = torch.from_numpy(late)
    start = dataclasses.replace(ts_state)
    rng = np.random.default_rng(SEED)
    actions = rng.integers(0, 4, (STEPS, B)).astype(np.int32)
    actions[:, :8] = 0  # lanes that stall in shaped mode
    jstep = jax.jit(lambda s, a: jenv.step(jcfg, s, a))
    dones = 0
    for t in range(STEPS):
        js, jts = jstep(js, jnp.asarray(actions[t]))
        ts_state, tts = tenv.step(tcfg, ts_state,
                                  torch.from_numpy(actions[t]), chain)
        assert_timesteps(tts, jts, shaped, f"{mode} step {t}")
        assert_states(ts_state, js, shaped, f"{mode} step {t}")
        dones += int(jts.done.sum())
    assert dones > B // 4

    # The same decisions through ReplaySpawns give the same trajectory.
    replay = tenv.ReplaySpawns(chain.spawns, chain.fresh_boards[1:])
    again = start
    for t in range(STEPS):
        again, _ = tenv.Game2048Env(tcfg).step(
            again, torch.from_numpy(actions[t]), replay)
    for f in dataclasses.fields(tenv.EnvState):
        assert torch.equal(getattr(again, f.name), getattr(ts_state, f.name))


def test_replay_source_checks_what_it_hands_back():
    replay = tenv.ReplaySpawns(
        [(torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.int8))],
        [torch.zeros((2, 4, 4), dtype=torch.int8)])
    with pytest.raises(ValueError, match="replayed spawns"):
        replay.spawn(torch.zeros((3, 4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="replayed boards"):
        replay.fresh(3)


# ---------------------------------------------------------------------------
# The production source's distribution
# ---------------------------------------------------------------------------

# Chi-square critical values at p = 0.001 (7 and 1 degrees of freedom).
CHI2_7, CHI2_1 = 24.32, 10.83


def test_generator_spawns_are_uniform_over_the_probe_empties():
    """Quirk mode on the clobber board: each spawn lands on one of the
    probe board's 8 empties, uniformly, and is a 2 with p = 0.9."""
    n = 16384
    tcfg = tenv.EnvConfig(reward="simple", quirk_compat=True,
                          auto_reset=False)
    source = tenv.GeneratorSpawns(SEED, "cpu")
    state = tenv.reset(tcfg, source, n)
    state.board = torch.from_numpy(np.tile(exps(CLOBBER), (n, 1, 1)))
    _, ts = tenv.step(tcfg, state, torch.full((n,), 1, dtype=torch.int32),
                      source)
    probe = exps([[4, 8, 0, 0], [16, 32, 0, 0], [64, 128, 0, 0],
                  [256, 4, 0, 0]])
    diff = ts.obs.numpy() != probe[None]
    assert (diff.sum(axis=(1, 2)) == 1).all()
    lane, rows, cols = np.nonzero(diff)
    assert (cols >= 2).all()
    counts = np.bincount(rows * 2 + (cols - 2), minlength=8)
    chi2 = ((counts - n / 8) ** 2 / (n / 8)).sum()
    assert chi2 < CHI2_7, counts
    twos = int((ts.obs.numpy()[lane, rows, cols] == 1).sum())
    chi2 = (twos - 0.9 * n) ** 2 / (0.9 * n) + (
        (n - twos) - 0.1 * n) ** 2 / (0.1 * n)
    assert chi2 < CHI2_1, twos
    fresh = source.fresh(n).numpy().reshape(n, 16)
    assert ((fresh != 0).sum(-1) == 2).all()
    assert np.bincount(np.nonzero(fresh)[1], minlength=16).min() > 0
