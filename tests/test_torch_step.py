"""The port's env step against the JAX package's, on the same bits.

``plain_env_step`` (what ``fused_env_step`` runs on a CPU tensor) is held
bit for bit against JAX ``lax_fast_step`` over multi-step trajectories and
against the Pallas ``fused_env_step`` in interpret mode, in simple and
shaped modes, with every emit flag, lanes with ``action=-1`` and the edge
bit patterns 0, 0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF in every bit row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.env import fast as jfast
from tpu2048.ops import pallas_step as jps
from tpu2048_torch.ops import step_kernel as sk

B = 256
EDGE_BITS = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def make_bits(seed, b=B):
    """(8, b) uint32 rows; lanes 0-3 and ~10% of the rest hold edge patterns."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, (8, b), dtype=np.uint64).astype(np.uint32)
    u[:, :4] = EDGE_BITS
    edge = rng.random((8, b)) < 0.1
    u[edge] = rng.choice(EDGE_BITS, edge.sum())
    return u


def make_boards(seed, b=B):
    """(b, 4, 4) int8: sparse, dense, full and tied-maximum boards."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(1, 12, (b, 4, 4))
    boards[rng.random((b, 4, 4)) < 0.3] = 0
    q = b // 4
    # Full boards with few pairs: many end the game this step.
    boards[q:2 * q] = rng.integers(1, 12, (q, 4, 4))
    # Checkerboards: game over already, every move invalid.
    boards[2 * q:2 * q + 8] = np.where(
        (np.arange(4)[:, None] + np.arange(4)) % 2 == 0, 1, 2)
    # Two equal maxima: second_exp must equal max_exp.
    boards[2 * q + 8:2 * q + 16] = 3
    boards[2 * q + 8:2 * q + 16, 0, 0] = 11
    boards[2 * q + 8:2 * q + 16, 3, 3] = 11
    return boards.astype(np.int8)


def make_actions(seed, b=B):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, b)
    a[rng.random(b) < 0.3] = -1
    return a.astype(np.int32)


def to_torch(x):
    """A writable copy; uint32 bits become int32 storage of the pattern."""
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def assert_same(port_out, jax_out):
    assert len(port_out) == len(jax_out)
    for i, (t, j) in enumerate(zip(port_out, jax_out)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, (i, t.dtype, j.dtype)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"output {i}")


@functools.partial(jax.jit, static_argnames=("shaped",))
def jax_lax_step(boards_cm, actions, bits, force_done, shaped):
    return jfast.lax_fast_step(boards_cm, actions, bits,
                               force_done if shaped else None,
                               shaped_done=shaped)


@pytest.mark.parametrize("emit_legal", [False, True])
@pytest.mark.parametrize("emit_pre_reset", [False, True])
@pytest.mark.parametrize("shaped", [False, True])
def test_plain_matches_pallas_kernel(shaped, emit_pre_reset, emit_legal):
    boards = jps.to_cell_major(jnp.asarray(make_boards(1)))
    actions, bits = make_actions(2), make_bits(3)
    force_done = np.random.default_rng(4).random(B) < 0.1
    want = jps.fused_env_step(
        boards, jnp.asarray(actions), 0, jnp.asarray(bits),
        jnp.asarray(force_done) if shaped else None,
        block_size=128, emit_pre_reset=emit_pre_reset,
        emit_legal=emit_legal, interpret=True,
    )
    got = sk.plain_env_step(
        to_torch(boards), to_torch(actions), to_torch(bits),
        to_torch(force_done) if shaped else None,
        emit_pre_reset=emit_pre_reset, emit_legal=emit_legal,
    )
    assert_same(got, want)


@pytest.mark.parametrize("shaped", [False, True])
def test_trajectory_matches_lax_step(shaped):
    """32 steps fed back into themselves; each step has fresh bits."""
    boards = jps.to_cell_major(jnp.asarray(make_boards(5)))
    port_boards = to_torch(boards)
    seen_done = seen_tie = 0
    for t in range(32):
        actions, bits = make_actions(100 + t), make_bits(200 + t)
        force_done = np.random.default_rng(300 + t).random(B) < 0.02
        want = jax_lax_step(boards, jnp.asarray(actions), jnp.asarray(bits),
                            jnp.asarray(force_done), shaped)
        got = sk.fused_env_step(
            port_boards, to_torch(actions), to_torch(bits),
            to_torch(force_done) if shaped else None,
            emit_pre_reset=True, emit_legal=True,
        )
        assert_same(got, want)
        boards, port_boards = want[0], got[0]
        seen_done += int(got[3].sum())
        seen_tie += int((got[4] == got[5]).sum())
    assert seen_done > 0 and seen_tie > 0


def test_cell_major_round_trip():
    boards = make_boards(6)
    cm = sk.to_cell_major(torch.from_numpy(boards))
    assert cm.shape == (16, B) and cm.is_contiguous()
    np.testing.assert_array_equal(
        cm.numpy(), np.asarray(jps.to_cell_major(jnp.asarray(boards))))
    np.testing.assert_array_equal(sk.from_cell_major(cm).numpy(), boards)


def test_rand_legal_action_matches_jax():
    # Every legal mask (all 16) against every edge pattern and random bits.
    masks = (np.arange(16)[:, None] >> np.arange(4)) & 1
    legal = np.repeat(masks, 64, axis=0).astype(bool)
    row = make_bits(7, b=len(legal))[0]
    got = sk.rand_legal_action(torch.from_numpy(legal), to_torch(row))
    want = jfast._rand_legal_action(jnp.asarray(legal), jnp.asarray(row))
    assert_same((got,), (want,))


def test_reset_boards_match_kernel_reset():
    """reset_boards is the kernel's auto-reset: compare with the lanes the
    JAX step resets (a checkerboard ends the game on any move)."""
    checker = np.where((np.arange(4)[:, None] + np.arange(4)) % 2 == 0, 1, 2)
    boards = np.broadcast_to(checker, (B, 4, 4)).astype(np.int8)
    bits = make_bits(8)
    want = jax_lax_step(jps.to_cell_major(jnp.asarray(boards)),
                        jnp.zeros(B, jnp.int32), jnp.asarray(bits), None,
                        False)
    assert bool(np.asarray(want[3]).all())
    got = sk.reset_boards(to_torch(bits))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jps.from_cell_major(want[0])))


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device"])
def test_fused_env_step_rejects_bad_inputs(bad):
    boards = torch.from_numpy(make_boards(9).reshape(B, 16).T.copy())
    actions = torch.from_numpy(make_actions(10))
    bits = to_torch(make_bits(11))
    if bad == "dtype":
        actions = actions.to(torch.int64)
    elif bad == "shape":
        bits = bits[:7]
    elif bad == "strided":
        boards = torch.from_numpy(make_boards(9).reshape(B, 16)).T
    else:
        actions = actions.to("meta")
    with pytest.raises(ValueError):
        sk.fused_env_step(boards, actions, bits)


@pytest.mark.parametrize("shaped", [False, True])
def test_out_of_range_actions_match_lax_step(shaped):
    """Actions 4, 7 and 100 (outside [-1, 4)) leave the board as it was
    with a zero score and moved=False in both packages: JAX's one-hot
    selects nothing, and so does the port's (the kernel skips the merge).
    Every output, on the same bits, beside lanes with in-range actions."""
    boards = jps.to_cell_major(jnp.asarray(make_boards(12)))
    actions = make_actions(13)
    actions[::3] = np.array([4, 7, 100])[np.arange(len(actions[::3])) % 3]
    bits = make_bits(14)
    force_done = np.random.default_rng(15).random(B) < 0.1
    want = jax_lax_step(boards, jnp.asarray(actions), jnp.asarray(bits),
                        jnp.asarray(force_done), shaped)
    got = sk.plain_env_step(
        to_torch(boards), to_torch(actions), to_torch(bits),
        to_torch(force_done) if shaped else None,
        emit_pre_reset=True, emit_legal=True,
    )
    assert_same(got, want)
    out = actions >= 4
    assert not got[2].numpy()[out].any() and not got[1].numpy()[out].any()
    pre_reset = got[-2].numpy()
    np.testing.assert_array_equal(pre_reset[:, out],
                                  np.asarray(boards)[:, out])
