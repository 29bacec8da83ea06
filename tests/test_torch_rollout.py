"""The port's rollout against the JAX package's, on the same bits.

``plain_env_rollout`` (what ``fused_env_rollout`` runs on a CPU tensor) is
held bit for bit, every output, against the Pallas ``fused_env_rollout`` in
interpret mode fed the same ``(8 * k, B)`` rows, across windows whose
outputs feed the next, in simple mode with and without the terminal bonus,
with and without the eval latches, and in shaped mode with and without
``reset_shaping`` and a stall limit of 3. The start boards include dead
ones, and dead ones holding a 2048 or two 1024s (the terminal bonus), and
the bit rows hold the edge patterns 0, 0x7FFFFFFF, 0x80000000 and
0xFFFFFFFF. Then the fast-env functions: ``fast_rollout`` equals k
``fast_step`` calls across episode resets, ``fast_rollout_eval`` equals JAX's
``backend="lax"`` oracle on the bits it draws, and the stall cutoff works as
in tests/test_shaped_rollout.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.env import fast as jfast
from tpu2048.ops import pallas_step as jps
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops import step_kernel as sk

B, BLOCK, K, WINDOWS = 256, 128, 3, 3
EDGE_BITS = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
CHECKER = np.where((np.arange(4)[:, None] + np.arange(4)) % 2 == 0, 1, 2)


def to_torch(x):
    """A writable copy; uint32 bits become int32 storage of the pattern."""
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def make_bits(rng, rows, b=B):
    """(rows, b) uint32; lanes 0-3 and ~10% of the rest hold edge patterns."""
    u = rng.integers(0, 2**32, (rows, b), dtype=np.uint64).astype(np.uint32)
    u[:, :4] = EDGE_BITS
    edge = rng.random((rows, b)) < 0.1
    u[edge] = rng.choice(EDGE_BITS, edge.sum())
    return u


def make_boards(rng, b=B):
    """(16, b) int8 cell-major: sparse and full boards, and dead boards (no
    move is legal) plain, with one 2048 and with two 1024s."""
    boards = rng.integers(1, 10, (b, 4, 4))
    boards[rng.random((b, 4, 4)) < 0.3] = 0
    q = b // 4
    boards[q:2 * q] = rng.integers(1, 10, (q, 4, 4))
    boards[2 * q:2 * q + 8] = CHECKER
    boards[2 * q + 8:2 * q + 16] = CHECKER
    boards[2 * q + 8:2 * q + 16, 1, 2] = 11
    boards[2 * q + 16:2 * q + 24] = CHECKER
    boards[2 * q + 16:2 * q + 24, 0, 0] = 10
    boards[2 * q + 16:2 * q + 24, 3, 3] = 10
    return boards.reshape(b, 16).T.astype(np.int8).copy()


def flat(outs):
    """The rollout's outputs with the latch and stall tuples spread out."""
    return [x for o in outs for x in (o if isinstance(o, tuple) else (o,))]


# (terminal_bonus, latch, shaped, reset_shaping): each switch both ways.
MODES = [
    pytest.param(True, True, False, False, id="simple-bonus-latch"),
    pytest.param(False, False, False, False, id="simple-nobonus"),
    pytest.param(True, True, True, False, id="shaped-latch"),
    pytest.param(True, False, True, True, id="shaped-reset"),
]


@pytest.mark.parametrize("terminal_bonus,latch,shaped,reset_shaping", MODES)
def test_plain_rollout_matches_pallas_interpret(terminal_bonus, latch, shaped,
                                                reset_shaping):
    rng = np.random.default_rng(7)
    zero = np.zeros(B, np.int32)
    lanes = [make_boards(rng), rng.integers(0, 500, B).astype(np.int32),
             rng.integers(0, 50, B).astype(np.int32),
             rng.integers(-40, 400, B).astype(np.float32)]
    latch_np = (np.zeros(B, np.int8), zero, zero, np.zeros(B, np.int8),
                np.zeros((4, B), np.int32)) if latch else None
    stall_np = (rng.integers(-1, 4, B).astype(np.int32),
                rng.integers(0, 4, B).astype(np.int32)) if shaped else None
    j_in = [[jnp.asarray(x) for x in lanes],
            latch_np and tuple(map(jnp.asarray, latch_np)),
            stall_np and tuple(map(jnp.asarray, stall_np))]
    t_in = [[to_torch(x) for x in lanes],
            latch_np and tuple(map(to_torch, latch_np)),
            stall_np and tuple(map(to_torch, stall_np))]
    kw = dict(terminal_bonus=terminal_bonus, stall_limit=3,
              reset_shaping=reset_shaping)
    dones = 0
    for _ in range(WINDOWS):
        bits = make_bits(rng, 8 * K)
        want = jps.fused_env_rollout(
            *j_in[0], 0, K, jnp.asarray(bits), j_in[1], j_in[2],
            block_size=BLOCK, interpret=True, **kw)
        got = sk.fused_env_rollout(*t_in[0], K, to_torch(bits), t_in[1],
                                   t_in[2], **kw)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(flat(got), flat(want))):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, (i, g.dtype, w.dtype)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
        dones += int(got[5].sum())
        j_in = [list(want[:4]), want[6] if latch else None,
                want[-1] if shaped else None]
        t_in = [list(got[:4]), got[6] if latch else None,
                got[-1] if shaped else None]
    assert dones > 8  # the dead boards alone end 24 episodes
    if not shaped:
        assert int(got[4].abs().sum()) > 0


def near_full_boards(rng, b):
    """(16, b) int8 boards of small tiles, ~85% full: games near their end."""
    full = rng.integers(1, 6, (16, b)).astype(np.int8)
    full[rng.random((16, b)) < 0.15] = 0
    return full


def near_end_state(config, seed, b=64, steps=40):
    """A state some random steps into games that started on near-full
    boards, so that windows cross episode resets."""
    rng = np.random.default_rng(seed)
    bits = tfast.ReplayBits(to_torch(make_bits(rng, 8, b))
                            for _ in range(steps + 1))
    state = tfast.fast_reset(bits, b, config)
    state.boards = to_torch(near_full_boards(rng, b))
    state.legal = board_ops.legal_moves_mask(sk.from_cell_major(state.boards))
    for _ in range(steps):
        state, _ = step_random(config, state, bits)
    return state


def step_random(config, state, bits):
    """One :func:`fast_step` of the random-legal policy; a shaped step gets
    the action resolved from the step's row 0, as JAX's lax oracle does."""
    rows = bits(state.batch_size)
    replay = tfast.ReplayBits([rows])
    if not config.shaped:
        return tfast.fast_step(config, state, replay)
    legal = board_ops.legal_moves_mask(sk.from_cell_major(state.boards))
    return tfast.fast_step(config, state, replay,
                           sk.rand_legal_action(legal, rows[0]))


@pytest.mark.parametrize("shaped", [False, True], ids=["simple", "shaped"])
def test_fast_rollout_equals_single_steps(shaped):
    config = tfast.FastEnvConfig(terminal_bonus=True, shaped=shaped,
                                 stall_force_done=6)
    state = near_end_state(config, 3)
    rng = np.random.default_rng(4)
    k, b = 6, state.batch_size
    total_done = 0
    for _ in range(4):
        rows = [to_torch(make_bits(rng, 8, b)) for _ in range(k)]
        ref = state
        reward = torch.zeros(b, dtype=torch.float32)
        done = torch.zeros(b, dtype=torch.int32)
        steps = tfast.ReplayBits(rows)
        for _ in range(k):
            ref, ts = step_random(config, ref, steps)
            reward += ts.reward
            done += ts.done.to(torch.int32)
        state, reward_sum, done_count = tfast.fast_rollout(
            config, state, tfast.ReplayBits(rows), k)
        names = ["boards", "score", "episode_steps"]
        if shaped:
            names += ["consec_action", "consec_count"]
            assert not reward_sum.any()  # a shaped window keeps no rewards
        else:
            names += ["episode_return"]
            assert torch.equal(reward_sum, reward.to(torch.int32))
        for name in names:
            assert torch.equal(getattr(state, name), getattr(ref, name)), name
        assert torch.equal(done_count, done)
        total_done += int(done.sum())
    assert total_done > 0


def jax_state_to_port(js, shaped):
    names = ["boards", "legal", "score", "episode_steps", "episode_return"]
    cls = tfast.FastEnvState
    if shaped:
        names += ["prev_max", "consec_action", "consec_count",
                  "last_consec_penalty"]
        cls = tfast.ShapedFastEnvState
    return cls(**{n: to_torch(getattr(js, n)) for n in names})


def jax_window_bits(js, k):
    """The rows JAX's lax oracle draws for the window at ``js.seed``."""
    return tfast.ReplayBits(
        to_torch(jax.random.bits(
            jax.random.fold_in(jax.random.PRNGKey(2048), js.seed + i),
            (8, js.boards.shape[1]), jnp.uint32))
        for i in range(k))


@pytest.mark.parametrize("shaped", [False, True], ids=["simple", "shaped"])
def test_rollout_eval_matches_jax_lax_oracle(shaped):
    b, k = 32, 8
    jcfg = jfast.FastEnvConfig(
        terminal_bonus=True, shaped=shaped, max_consecutive_actions=3,
        stall_force_done=5, interpret=True, external_rng=True, backend="lax")
    tcfg = tfast.FastEnvConfig(terminal_bonus=True, shaped=shaped,
                               max_consecutive_actions=3, stall_force_done=5)
    js = jfast.fast_reset(jcfg, jax.random.PRNGKey(5), b)
    boards = jnp.asarray(near_full_boards(np.random.default_rng(6), b))
    legal = jax.jit(jfast.board_ops.legal_moves_mask)(
        jps.from_cell_major(boards))
    js = js.replace(boards=boards, legal=legal)
    ts = jax_state_to_port(js, shaped)
    jl, tl = jfast.eval_latch_init(b), tfast.eval_latch_init(b, "cpu")
    for _ in range(4):
        bits = jax_window_bits(js, k)
        js, jl = jfast.fast_rollout_eval(jcfg, js, jl, k)
        ts, tl = tfast.fast_rollout_eval(tcfg, ts, tl, bits, k)
        for name in ("latched", "score", "steps", "max_exp",
                     "action_counts"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)),
                                          err_msg=name)
        names = ["boards", "score", "episode_steps"]
        # The oracle steps the shaped env, whose return holds the shaped
        # rewards; the window keeps none (the reference's contract).
        names += (["consec_action", "consec_count"] if shaped
                  else ["episode_return"])
        for name in names:
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=name)
    assert int(tl.latched.sum()) > 0
    done = tl.latched != 0
    assert torch.equal(tl.action_counts.sum(0)[done], tl.steps[done])


@pytest.mark.parametrize("reset_shaping", [False, True])
def test_stall_cutoff_and_persistence(reset_shaping):
    """A stall limit of 0 forces every step to end its episode; the stall
    lanes persist across those ends unless ``reset_shaping``."""
    b, k = 8, 5
    config = tfast.FastEnvConfig(shaped=True, stall_force_done=0,
                                 reset_shaping=reset_shaping)
    bits = tfast.PhiloxBits(2, "cpu")
    state = tfast.fast_reset(bits, b, config)
    state, reward_sum, done_count = tfast.fast_rollout(config, state, bits,
                                                       k)
    assert torch.equal(done_count, torch.full((b,), k, dtype=torch.int32))
    assert not reward_sum.any()
    if reset_shaping:
        assert torch.equal(state.consec_count,
                           torch.zeros(b, dtype=torch.int32))
        assert torch.equal(state.consec_action,
                           torch.full((b,), -1, dtype=torch.int32))
    else:
        assert (state.consec_count >= 1).all()
        assert (state.consec_action >= 0).all()
    assert not state.episode_steps.any()
