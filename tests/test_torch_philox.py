"""The rollout's Philox bits: the generator against the Random123
known-answer vectors and a plain Python Philox4x32-10, the row layout of
``philox_rows``, Philox mode against external rows, window splits, and the
distributions the env draws from them (the counterpart of
tests/test_pallas_step.py::test_kernel_spawn_distribution).
"""

import numpy as np
import pytest
import torch

from tpu2048_torch.env import fast as tfast
from tpu2048_torch.ops import step_kernel as sk

M32 = 0xFFFFFFFF


def philox_reference(counter, key):
    """Philox4x32-10 on Python ints (Random123's round function)."""
    c, k = list(counter), list(key)
    for i in range(10):
        if i:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & M32]
    return c


# Random123's known-answer vectors for philox4x32_10.
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_known_answers(counter, key, want):
    got = sk.philox4x32(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert [int(w) for w in got] == list(want)
    assert philox_reference(counter, key) == list(want)


def test_rows_are_counted_by_lane_step_and_half():
    seed, step, k, b = 0x0123456789ABCDEF, 2**32 - 2, 3, 5
    rows = sk.philox_rows(seed, step, k, b, "cpu")
    assert rows.shape == (8 * k, b) and rows.dtype == torch.int32
    words = rows.to(torch.int64) & M32
    key = (seed & M32, seed >> 32)
    for i in range(k):  # the step's high word turns over at i = 2
        s = step + i
        for lane in range(b):
            for half in (0, 1):
                want = philox_reference((lane, s & M32, s >> 32, half), key)
                got = words[8 * i + 4 * half:8 * i + 4 * half + 4, lane]
                assert got.tolist() == want


def rollout_inputs(seed, b, latch):
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 6, (16, b)).astype(np.int8)
    zero = torch.zeros(b, dtype=torch.int32)
    lanes = (torch.from_numpy(boards), zero, zero,
             torch.zeros(b, dtype=torch.float32))
    latch_state = (torch.zeros(b, dtype=torch.int8), zero, zero,
                   torch.zeros(b, dtype=torch.int8),
                   torch.zeros((4, b), dtype=torch.int32)) if latch else None
    return lanes, latch_state


@pytest.mark.parametrize("shaped", [False, True], ids=["simple", "shaped"])
def test_philox_mode_equals_external_rows(shaped):
    b, k, seed, step = 128, 8, 2**40 + 3, 17
    lanes, latch_state = rollout_inputs(1, b, latch=True)
    stall = ((torch.full((b,), -1, dtype=torch.int32),
              torch.zeros(b, dtype=torch.int32)) if shaped else None)
    kw = dict(stall_limit=2)
    got = sk.fused_env_rollout(*lanes, k, None, latch_state, stall,
                               seed=seed, step=step, **kw)
    want = sk.fused_env_rollout(*lanes, k,
                                sk.philox_rows(seed, step, k, b, "cpu"),
                                latch_state, stall, **kw)
    flat = [x for o in got for x in (o if isinstance(o, tuple) else (o,))]
    flat_w = [x for o in want for x in (o if isinstance(o, tuple) else (o,))]
    assert len(flat) == len(flat_w)
    for g, w in zip(flat, flat_w):
        assert torch.equal(g, w)
    assert int(got[5].sum()) > 0  # the window crossed episode ends


def test_one_window_equals_sixteen_single_step_windows():
    config = tfast.FastEnvConfig(terminal_bonus=True)
    one, many = tfast.PhiloxBits(9, "cpu"), tfast.PhiloxBits(9, "cpu")
    state_one = tfast.fast_reset(one, 96, config)
    state_many = tfast.fast_reset(many, 96, config)
    state_one, reward_one, done_one = tfast.fast_rollout(config, state_one,
                                                         one, 16)
    reward_many = torch.zeros(96, dtype=torch.int32)
    done_many = torch.zeros(96, dtype=torch.int32)
    for _ in range(16):
        state_many, reward, done = tfast.fast_rollout(config, state_many,
                                                      many, 1)
        reward_many += reward
        done_many += done
    assert one.step == many.step == 17  # the reset's draw, then 16 steps
    for name in ("boards", "score", "episode_steps", "episode_return"):
        assert torch.equal(getattr(state_one, name),
                           getattr(state_many, name)), name
    assert torch.equal(reward_one, reward_many)
    assert torch.equal(done_one, done_many)


def test_spawn_share_of_twos():
    """Merges keep the sum of tile values, so one step's spawn is the sum
    after less the sum before; P(2) must be ~0.9."""
    b = 8192
    rng = np.random.default_rng(2)
    boards = rng.integers(1, 4, (16, b)).astype(np.int8)
    boards[rng.random((16, b)) < 0.5] = 0
    boards[:, 0] = 0
    lanes = (torch.from_numpy(boards), torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, dtype=torch.float32))
    out = sk.fused_env_rollout(*lanes, 1, seed=5, step=0)
    done = out[5] != 0
    assert not done.any()

    def value(cm):
        e = cm.to(torch.int64)
        return torch.where(e > 0, torch.ones_like(e) << e, 0).sum(0)

    spawn = value(out[0]) - value(lanes[0])
    moved = spawn != 0
    assert moved.float().mean() > 0.99  # nearly every sparse board moves
    assert set(spawn[moved].unique().tolist()) <= {2, 4}
    share = (spawn[moved] == 2).float().mean().item()
    assert 0.85 < share < 0.95, share


def test_random_picks_are_uniform_over_legal_moves():
    """A board of two 4s in the top-left corner can move left, right and
    down, not up: each of the three takes ~1/3 of the picks."""
    b = 6000
    board = np.zeros(16, np.int8)
    board[:2] = 2
    lanes, latch_state = rollout_inputs(0, b, latch=True)
    lanes = (torch.from_numpy(np.tile(board[:, None], (1, b))),) + lanes[1:]
    out = sk.fused_env_rollout(*lanes, 1, None, latch_state, seed=11,
                               step=3)
    counts = out[6][4].sum(1)
    assert int(counts.sum()) == b and int(counts[1]) == 0
    shares = counts[[0, 2, 3]].double() / b
    assert ((shares - 1 / 3).abs() < 0.03).all(), shares.tolist()
