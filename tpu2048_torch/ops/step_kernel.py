"""The env kernels: one whole 2048 step per lane, and k random-legal steps
per lane in one launch; the port of :mod:`tpu2048.ops.pallas_step`'s
``_step_kernel`` and ``_rollout_kernel``.

:func:`fused_env_step` and :func:`fused_env_rollout` launch the CUDA kernels
in ``csrc/step_kernel.cu`` on a CUDA tensor and run :func:`plain_env_step`
and :func:`plain_env_rollout`, the same functions in plain PyTorch, on a CPU
tensor. There is no fallback from the card to the plain versions. The
rollout kernel has two layouts, four threads a lane below ``QUAD_BATCH``
lanes and one thread a lane from there up; :func:`rollout_geometry` picks.

Layout: boards are cell-major ``(16, B)`` int8 (cell ``r*4+c`` is row
``r*4+c``). Randomness comes from the caller as ``(8, B)`` int32 rows that
hold the raw uint32 bit patterns, in the TPU kernel's row order: action-pick,
unused, spawn-pos, spawn-val, reset-p1, reset-p2, reset-v1, reset-v2. torch
has no unsigned 32-bit arithmetic on the CPU, so the plain version widens the
rows to int64 and masks them; the kernel reads them as ``uint32_t``.

The rollout's production bits are Philox4x32-10 (Random123), drawn inside the
kernel; :func:`philox_rows` is the same generator in plain PyTorch. It is
keyed by a 64-bit seed and counts by ``(lane, step_lo, step_hi, half)``:
half 0 gives bit rows 0-3 of step ``step`` and half 1 rows 4-7.

The kernel is built with ``nvcc`` at first use, from the source in the
package, into ``build/`` beside the package, and loaded with ``ctypes``
(:mod:`tpu2048_torch.ops._build`).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Tuple

import torch

from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops._build import CudaLibrary


def to_cell_major(boards: torch.Tensor) -> torch.Tensor:
    """``(B, 4, 4)`` -> contiguous ``(16, B)`` int8."""
    return boards.reshape(boards.shape[0], 16).T.contiguous()


def from_cell_major(boards_cm: torch.Tensor) -> torch.Tensor:
    """``(16, B)`` -> ``(B, 4, 4)`` int8."""
    return boards_cm.T.reshape(-1, 4, 4)


def _unsigned(bits: torch.Tensor) -> torch.Tensor:
    """int32 storage of uint32 patterns -> int64 values in ``[0, 2**32)``."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def _uniform_mod(bits: torch.Tensor, n) -> torch.Tensor:
    """int32 in ``[0, n)`` from the top 31 bits (``pallas_step._uniform_mod``)."""
    n = torch.as_tensor(n, device=bits.device).clamp_min(1)
    return ((_unsigned(bits) >> 1) % n).to(torch.int32)


def _tile_value(bits: torch.Tensor) -> torch.Tensor:
    """int8 exponent 1 (p = 0.9) or 2, from the full unsigned value modulo 10
    (``pallas_step._tile_value``)."""
    one = torch.ones((), dtype=torch.int8, device=bits.device)
    return torch.where(_unsigned(bits) % 10 < 9, one, one + 1)


def rand_legal_action(legal: torch.Tensor, rng_row: torch.Tensor) -> torch.Tensor:
    """The kernel's uniform-over-legal pick (``tpu2048.env.fast.
    _rand_legal_action``): ``(B, 4)`` bool mask and one ``(B,)`` bit row ->
    ``(B,)`` int32; 0 where nothing is legal."""
    legal_i = legal.to(torch.int32)
    pick = _uniform_mod(rng_row, legal_i.sum(-1))
    before = legal_i.cumsum(-1) - legal_i
    hit = legal & (before == pick.unsqueeze(-1))
    # argmax returns the first maximum, like jnp.argmax; bool has none.
    return hit.to(torch.int8).argmax(-1).to(torch.int32)


def reset_boards(rng_bits: torch.Tensor) -> torch.Tensor:
    """Fresh two-tile ``(B, 4, 4)`` int8 boards from bit rows 4-7, by the
    kernel's auto-reset rule: cells p1 != p2, uniform; values 2 (p = 0.9)
    or 4. This is ``init_board``'s distribution."""
    b = rng_bits.shape[1]
    p1 = _uniform_mod(rng_bits[4], 16)
    p2r = _uniform_mod(rng_bits[5], 15)
    p2 = torch.where(p2r >= p1, p2r + 1, p2r)
    cells = torch.arange(16, device=rng_bits.device)
    zero = torch.zeros((), dtype=torch.int8, device=rng_bits.device)
    fresh = torch.where(
        cells == p1.unsqueeze(-1),
        _tile_value(rng_bits[6]).unsqueeze(-1),
        torch.where(cells == p2.unsqueeze(-1),
                    _tile_value(rng_bits[7]).unsqueeze(-1), zero),
    )
    return fresh.view(b, 4, 4)


def plain_env_step(boards, actions, rng_bits, force_done=None, *,
                   emit_pre_reset: bool = False, emit_legal: bool = False):
    """The kernel's function in plain PyTorch, on :mod:`board_ops`.

    Mirrors ``tpu2048.env.fast.lax_fast_step``; arguments and outputs are
    those of :func:`fused_env_step`.
    """
    board = from_cell_major(boards)
    b = board.shape[0]
    cand_b, cand_s, cand_m = board_ops.move_all(board)
    legal = cand_m.movedim(0, -1)
    action = torch.where(actions < 0, rand_legal_action(legal, rng_bits[0]),
                         actions)
    merged, score, moved = board_ops.select_move(cand_b, cand_s, cand_m, action)

    n_empty = (merged == 0).flatten(-2).sum(-1, dtype=torch.int32)
    spawned = board_ops.spawn_at(
        merged, _uniform_mod(rng_bits[2], n_empty), _tile_value(rng_bits[3])
    )
    new_board = torch.where(moved[:, None, None], spawned, board)

    game_over = board_ops.is_game_over(new_board)
    if force_done is None:
        done = game_over
    else:
        done = (~moved & game_over) | force_done

    # Second max skips only the first max cell in cell order.
    flat = new_board.reshape(b, 16).to(torch.int32)
    mx = flat.amax(-1)
    first_max = (flat == mx.unsqueeze(-1)).to(torch.int8).argmax(-1)
    cells = torch.arange(16, device=flat.device)
    others = torch.where(cells == first_max.unsqueeze(-1), -1, flat)
    second = others.amax(-1).clamp_min(0)

    final = torch.where(done[:, None, None], reset_boards(rng_bits), new_board)
    out = (to_cell_major(final), score, moved, done, mx.to(torch.int8),
           second.to(torch.int8))
    if force_done is not None:
        out += (game_over,)
    if emit_pre_reset:
        out += (to_cell_major(new_board),)
    if emit_legal:
        legal_next = board_ops.legal_moves_mask(final)
        out += (legal_next.T.to(torch.int8).contiguous(),)
    return out


_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl constants)


def _mulhilo(a: torch.Tensor, m: int):
    """High and low words of ``a * m`` for int64 ``a`` in ``[0, 2**32)``: each
    product with a 16-bit half of ``m`` stays below ``2**48``."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    hi = (hi_part + (lo_part >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 words:
    ``counter`` four words, ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _as_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 storage of the same pattern."""
    return ((values ^ 0x80000000) - 0x80000000).to(torch.int32)


def philox_rows(seed: int, step: int, k: int, b: int, device) -> torch.Tensor:
    """The ``(8 * k, b)`` int32 bit rows of steps ``step .. step + k - 1``
    that the rollout kernel draws in Philox mode for lanes ``0 .. b - 1``."""
    lane = torch.arange(b, dtype=torch.int64, device=device)
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    rows = []
    for s in range(step, step + k):
        lo, hi = torch.full_like(lane, s & _MASK32), torch.full_like(
            lane, (s >> 32) & _MASK32)
        for half in (0, 1):
            rows += philox4x32((lane, lo, hi, torch.full_like(lane, half)),
                               key)
    return _as_int32(torch.stack(rows))


def plain_env_rollout(boards, score, steps, episode_return, k_steps,
                      rng_bits=None, latch_state=None, stall_state=None, *,
                      seed=None, step=None, terminal_bonus: bool = True,
                      stall_limit: int = 100, reset_shaping: bool = False):
    """The rollout kernel's function in plain PyTorch: ``k_steps`` calls of
    :func:`plain_env_step` with the resolved random-legal action, and the
    window sums, latches and stall lanes of ``pallas_step._rollout_kernel``.
    Arguments and outputs are those of :func:`fused_env_rollout`; with no
    ``rng_bits`` the rows come from :func:`philox_rows` at ``seed``,
    ``step``."""
    b = boards.shape[1]
    device = boards.device
    if rng_bits is None:
        rng_bits = philox_rows(seed, step, k_steps, b, device)
    shaped = stall_state is not None
    latch = latch_state is not None
    if shaped:
        consec_action, consec_count = stall_state
    if latch:
        latched, fscore, fsteps, fmax, acnt = latch_state
    ep_score, ep_steps, ep_ret = score, steps, episode_return
    reward_sum = torch.zeros(b, dtype=torch.int32, device=device)
    done_count = torch.zeros(b, dtype=torch.int32, device=device)
    directions = torch.arange(4, dtype=torch.int32, device=device)
    for it in range(k_steps):
        bits = rng_bits[8 * it:8 * it + 8]
        legal = board_ops.legal_moves_mask(from_cell_major(boards))
        action = rand_legal_action(legal, bits[0])
        force_done = None
        if shaped:
            new_count = torch.where(action == consec_action,
                                    consec_count + 1, 1)
            force_done = new_count > stall_limit
        boards, merge, moved, done, mx, second = plain_env_step(
            boards, action, bits, force_done)[:6]
        if shaped:
            consec_action, consec_count = action, new_count
            if reset_shaping:
                consec_action = torch.where(done, -1, consec_action)
                consec_count = torch.where(done, 0, consec_count)
            reward = torch.zeros_like(merge)
        else:
            reward = torch.where(~moved & ~done, -10, merge)
            if terminal_bonus:
                bonus = torch.where(
                    mx >= 11, 100,
                    torch.where((mx >= 10) & (second >= 10), 50, 0))
                reward = reward + torch.where(done, bonus, 0).to(torch.int32)
            reward_sum = reward_sum + reward
        done_count = done_count + done.to(torch.int32)
        if latch:
            live = latched == 0
            newly = live & done
            fscore = torch.where(newly, ep_score + merge, fscore)
            fsteps = torch.where(newly, ep_steps + 1, fsteps)
            fmax = torch.where(newly, mx, fmax)
            acnt = acnt + ((directions[:, None] == action)
                           & live).to(torch.int32)
            latched = torch.where(newly, 1, latched)
        ep_score = torch.where(done, 0, ep_score + merge)
        ep_steps = torch.where(done, 0, ep_steps + 1)
        ep_ret = torch.where(done, 0.0, ep_ret + reward.to(torch.float32))
    out = (boards, ep_score, ep_steps, ep_ret, reward_sum, done_count)
    if latch:
        out += ((latched, fscore, fsteps, fmax, acnt),)
    if shaped:
        out += ((consec_action, consec_count),)
    return out


def _device_index(boards, kind):
    """The CUDA device's index of ``boards``, or -1 for a CPU tensor; raises
    for any other device."""
    if boards.is_cuda:
        return boards.get_device()
    if boards.device.type != "cpu":
        raise ValueError(f"no {kind} kernel for device {boards.device}")
    return -1


def _check(name, t, shape, dtype, boards, index):
    """Raise unless ``t`` has ``shape`` and ``dtype``, lies on ``boards``'
    device (CUDA index ``index``, -1 for the CPU) and is contiguous."""
    if t.shape != shape or t.dtype is not dtype:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} "
            f"{t.dtype}"
        )
    if (t.get_device() != index or not t.is_cuda if index >= 0
            else t.device != boards.device):
        raise ValueError(f"{name} is on {t.device}, boards on {boards.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.tpu2048_step_kernel
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.tpu2048_rollout_kernel
    fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 4
                   + [ctypes.c_uint64] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tpu2048_noop_kernel
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("step_kernel.cu", _declare)
# The kernels' C entries, resolved once when the library loads.
_step_entry = None
_rollout_entry = None


def _load_step_entry():
    global _step_entry
    _step_entry = LIBRARY.load().tpu2048_step_kernel
    return _step_entry


def _load_rollout_entry():
    global _rollout_entry
    _rollout_entry = LIBRARY.load().tpu2048_rollout_kernel
    return _rollout_entry


def _ptr(t):
    return None if t is None else t.data_ptr()


# Mirrors of csrc/step_kernel.cu's launch constants: threads a block
# (kThreads); the rollout runs QUAD_THREADS threads a lane below
# QUAD_BATCH lanes (kQuadThreads, kQuadBatch), one thread a lane from it up.
THREADS = 128
QUAD_THREADS = 4
QUAD_BATCH = 21120


def rollout_geometry(batch: int) -> Tuple[int, int]:
    """The rollout kernel's launch at ``batch`` lanes: threads a lane (the
    layout the wrapper passes the C entry) and blocks of THREADS threads."""
    lane_threads = QUAD_THREADS if batch < QUAD_BATCH else 1
    return lane_threads, -(-batch * lane_threads // THREADS)


@functools.lru_cache(maxsize=64)
def output_layout(b: int, shaped: bool, emit_pre_reset: bool,
                  emit_legal: bool) -> Tuple[int, tuple, tuple]:
    """Where a step's outputs lie in the one int8 buffer that a launch
    allocates at batch ``b``: the buffer's bytes; the sizes of the outputs
    that are asked for, in memory order (the int32 score first, at the
    buffer's alignment, then max, second, valid, done, [game_over], then the
    ``(16, B)`` and ``(4, B)`` blocks: boards, [pre_reset], [legal]); and
    each output's byte offset in the C entry's order (boards, score, valid,
    done, max, second, game_over, pre_reset, legal), None where it is not
    asked for."""
    sizes = (4 * b, b, b, b, b, b * shaped, 16 * b, 16 * b * emit_pre_reset,
             4 * b * emit_legal)
    starts = tuple(itertools.accumulate(sizes, initial=0))
    offsets = tuple(starts[i] if sizes[i] else None
                    for i in (6, 0, 3, 4, 1, 2, 5, 7, 8))
    return starts[-1], tuple(n for n in sizes if n), offsets


def carve_outputs(buf: torch.Tensor, b: int, shaped: bool,
                  emit_pre_reset: bool, emit_legal: bool) -> tuple:
    """Cut a flat int8 buffer of :func:`output_layout`'s bytes into the
    step's outputs, those asked for, in the order :func:`fused_env_step`
    returns them (the C entry's order without the absent ones). No two
    views overlap."""
    # In memory: score, max, second, valid, done, [game_over], boards,
    # [pre_reset], [legal].
    parts = buf.split_with_sizes(
        output_layout(b, shaped, emit_pre_reset, emit_legal)[1])
    out = (parts[5 + shaped].view(16, b), parts[0].view(torch.int32),
           parts[3].view(torch.bool), parts[4].view(torch.bool), parts[1],
           parts[2])
    if shaped:
        out += (parts[5].view(torch.bool),)
    if emit_pre_reset:
        out += (parts[6 + shaped].view(16, b),)
    if emit_legal:
        out += (parts[-1].view(4, b),)
    return out


def _check_step(boards, actions, rng_bits, force_done):
    """Validate the step's inputs in one walk over their attributes; returns
    the batch and the CUDA device's index (-1 for CPU tensors)."""
    shape = boards.shape
    if len(shape) != 2 or shape[0] != 16:
        raise ValueError(f"boards: expected (16, B), got {tuple(shape)}")
    b = shape[1]
    if not b:
        raise ValueError("empty batch")
    index = _device_index(boards, "step")
    _check("boards", boards, shape, torch.int8, boards, index)
    _check("actions", actions, (b,), torch.int32, boards, index)
    _check("rng_bits", rng_bits, (8, b), torch.int32, boards, index)
    if force_done is not None:
        _check("force_done", force_done, (b,), torch.bool, boards, index)
    return b, index


def fused_env_step(boards, actions, rng_bits, force_done=None, *,
                   emit_pre_reset: bool = False, emit_legal: bool = False):
    """One env step for the whole batch.

    Port of ``tpu2048.ops.pallas_step.fused_env_step``. The bits always come
    from the caller, so the JAX launcher's ``seed`` (the TPU's on-core PRNG)
    has no counterpart, and neither have its TPU knobs ``block_size`` and
    ``interpret``.

    Args:
      boards: ``(16, B)`` int8 cell-major exponent boards.
      actions: ``(B,)`` int32; a value < 0 picks a uniformly random legal
        action in the kernel.
      rng_bits: ``(8, B)`` int32 bit rows (see the module docstring).
      force_done: optional ``(B,)`` bool. Given, the step runs the shaped
        env's done rule ``(~moved & game_over) | force_done`` and returns
        ``game_over`` after ``second_exp``; absent, ``done = game_over``.
      emit_pre_reset: also return the post-step board before auto-reset.
      emit_legal: also return the ``(4, B)`` int8 legal mask of the
        post-reset board.

    Returns:
      ``(new_boards, score, valid, done, max_exp, second_exp[, game_over]
      [, pre_reset][, legal_next])``: ``(16, B)`` int8, ``(B,)`` int32,
      ``(B,)`` bool, ``(B,)`` bool, ``(B,)`` int8, ``(B,)`` int8
      [, ``(B,)`` bool][, ``(16, B)`` int8][, ``(4, B)`` int8]. On the card
      they are views of one allocation (:func:`output_layout`).

    A CPU tensor runs :func:`plain_env_step`; a CUDA tensor launches the
    kernel (and counts it in ``fused_env_step.launches``) or raises. The
    launch goes to PyTorch's current stream of the boards' device:
    ``torch.accelerator.current_stream`` follows ``torch.cuda.stream`` and
    graph capture, as ``torch.cuda.current_stream`` does, without building a
    ``torch.cuda.Stream``.
    """
    b, index = _check_step(boards, actions, rng_bits, force_done)
    if index < 0:
        return plain_env_step(boards, actions, rng_bits, force_done,
                              emit_pre_reset=emit_pre_reset,
                              emit_legal=emit_legal)
    shaped = force_done is not None
    n_bytes, _, offsets = output_layout(b, shaped, emit_pre_reset, emit_legal)
    buf = boards.new_empty(n_bytes)
    base = buf.data_ptr()
    err = (_step_entry or _load_step_entry())(
        boards.data_ptr(), actions.data_ptr(), rng_bits.data_ptr(),
        None if force_done is None else force_done.data_ptr(),
        *[None if o is None else base + o for o in offsets], b, index,
        torch.accelerator.current_stream(index).native_handle)
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    fused_env_step.launches += 1
    return carve_outputs(buf, b, shaped, emit_pre_reset, emit_legal)


fused_env_step.launches = 0


@functools.lru_cache(maxsize=64)
def rollout_output_layout(b: int, latch: bool, shaped: bool
                          ) -> Tuple[int, tuple, tuple, tuple]:
    """Where a rollout's outputs lie in the one int8 buffer that a launch
    allocates at batch ``b``: the buffer's bytes; the 32-bit outputs that
    are asked for, first, at the buffer's alignment, by their sizes in
    words (score, steps, return, reward_sum, done_count, [consec_action,
    consec_count], [fscore, fsteps, acnt]); then the int8 ones by their
    sizes in bytes (boards, [latched, fmax]); and each output's byte offset
    in the C entry's order (boards, score, steps, return, reward_sum,
    done_count, consec_action, consec_count, latched, fscore, fsteps, fmax,
    acnt), None where it is not asked for."""
    words = (b,) * (5 + 2 * shaped) + (b, b, 4 * b) * latch
    cells = (16 * b,) + (b, b) * latch
    starts = tuple(itertools.accumulate((4 * n for n in words), initial=0))
    n32 = starts[-1]
    j = 5 + 2 * shaped  # the first latch output, fscore
    stall = (starts[5], starts[6]) if shaped else (None, None)
    latches = ((n32 + 16 * b, starts[j], starts[j + 1], n32 + 17 * b,
                starts[j + 2]) if latch else (None,) * 5)
    offsets = (n32, *starts[:5], *stall, *latches)
    return n32 + sum(cells), words, cells, offsets


def carve_rollout_outputs(buf: torch.Tensor, b: int, latch: bool,
                          shaped: bool) -> tuple:
    """Cut a flat int8 buffer of :func:`rollout_output_layout`'s bytes into
    the rollout's outputs, in the order and types :func:`fused_env_rollout`
    returns them. No two views overlap. The 32-bit outputs come from one
    split of one int32 view (each view made from Python costs the host
    more than the split's)."""
    _, words, cells, _ = rollout_output_layout(b, latch, shaped)
    n32 = 4 * sum(words)
    w = buf[:n32].view(torch.int32).split_with_sizes(words)
    c = buf[n32:].split_with_sizes(cells)
    out = (c[0].view(16, b), w[0], w[1], w[2].view(torch.float32), w[3],
           w[4])
    if latch:
        j = 5 + 2 * shaped
        out += ((c[1], w[j], w[j + 1], c[2], w[j + 2].view(4, b)),)
    if shaped:
        out += ((w[5], w[6]),)
    return out


_LATCH = (("latched", torch.int8), ("fscore", torch.int32),
          ("fsteps", torch.int32), ("fmax", torch.int8), ("acnt", torch.int32))


def _check_rollout(boards, score, steps, episode_return, k_steps, rng_bits,
                   latch_state, stall_state, seed, step):
    """Validate the rollout's inputs in one walk over their attributes;
    returns the batch and the CUDA device's index (-1 for CPU tensors)."""
    shape = boards.shape
    if len(shape) != 2 or shape[0] != 16:
        raise ValueError(f"boards: expected (16, B), got {tuple(shape)}")
    b = shape[1]
    if not b:
        raise ValueError("empty batch")
    if k_steps < 1:
        raise ValueError(f"k_steps must be at least 1, got {k_steps}")
    index = _device_index(boards, "rollout")
    _check("boards", boards, shape, torch.int8, boards, index)
    _check("score", score, (b,), torch.int32, boards, index)
    _check("steps", steps, (b,), torch.int32, boards, index)
    _check("episode_return", episode_return, (b,), torch.float32, boards,
           index)
    if rng_bits is None:
        if seed is None or step is None:
            raise ValueError("give rng_bits, or seed and step")
        if not (0 <= seed < 2**64 and 0 <= step and step + k_steps <= 2**64):
            raise ValueError(f"seed {seed} or step {step} out of range")
    else:
        if seed is not None or step is not None:
            raise ValueError("give rng_bits or seed and step, not both")
        _check("rng_bits", rng_bits, (8 * k_steps, b), torch.int32, boards,
               index)
    if latch_state is not None:
        for (name, dtype), t in zip(_LATCH, latch_state):
            _check(name, t, (4, b) if name == "acnt" else (b,), dtype, boards,
                   index)
    if stall_state is not None:
        for name, t in zip(("consec_action", "consec_count"), stall_state):
            _check(name, t, (b,), torch.int32, boards, index)
    return b, index


def launch_rollout(lane_threads, b, index, boards, score, steps,
                   episode_return, k_steps, rng_bits=None, latch_state=None,
                   stall_state=None, *, seed=None, step=None,
                   terminal_bonus: bool = True, stall_limit: int = 100,
                   reset_shaping: bool = False):
    """One rollout launch at ``lane_threads`` threads a lane (1 or
    QUAD_THREADS) on inputs that :func:`_check_rollout` passed at batch
    ``b`` on CUDA device ``index``: :func:`fused_env_rollout`'s launch, with
    the layout given instead of :func:`rollout_geometry`'s, so that both
    layouts can be held and timed at any batch. Counts the launch."""
    latch, shaped = latch_state is not None, stall_state is not None
    n_bytes, _, _, offsets = rollout_output_layout(b, latch, shaped)
    buf = boards.new_empty(n_bytes)
    base = buf.data_ptr()
    err = (_rollout_entry or _load_rollout_entry())(
        boards.data_ptr(), score.data_ptr(), steps.data_ptr(),
        episode_return.data_ptr(), _ptr(rng_bits),
        *(map(_ptr, stall_state) if shaped else (None,) * 2),
        *(map(_ptr, latch_state) if latch else (None,) * 5),
        *[None if o is None else base + o for o in offsets], k_steps,
        terminal_bonus, stall_limit, reset_shaping, seed or 0, step or 0, b,
        lane_threads, index,
        torch.accelerator.current_stream(index).native_handle)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: CUDA error {err}")
    fused_env_rollout.launches += 1
    return carve_rollout_outputs(buf, b, latch, shaped)


def fused_env_rollout(boards, score, steps, episode_return, k_steps,
                      rng_bits=None, latch_state=None, stall_state=None, *,
                      seed=None, step=None, terminal_bonus: bool = True,
                      stall_limit: int = 100, reset_shaping: bool = False):
    """``k_steps`` random-legal env steps for the whole batch in one launch.

    Port of ``tpu2048.ops.pallas_step.fused_env_rollout``, with the same
    outputs in the same order and types. Without its TPU knobs
    (``block_size``, ``interpret``); its on-core PRNG becomes Philox,
    selected by giving ``seed`` and ``step`` instead of ``rng_bits``.

    Args:
      boards: ``(16, B)`` int8 cell-major exponent boards.
      score, steps: ``(B,)`` int32 episode merge score and step count.
      episode_return: ``(B,)`` float32 episode reward sum.
      k_steps: steps in the window, at least 1.
      rng_bits: ``(8 * k_steps, B)`` int32 bit rows, 8 a step in
        :func:`fused_env_step`'s row order; or None with ``seed`` (a 64-bit
        Philox key) and ``step`` (the stream's step counter of the window's
        first step).
      latch_state: optional ``(latched, fscore, fsteps, fmax, acnt)``: ``(B,)``
        int8, int32, int32, int8 and ``(4, B)`` int32. Each lane's first
        completion latches its score, length and max exponent; its actions
        count while it is not latched.
      stall_state: optional ``(consec_action, consec_count)`` ``(B,)`` int32:
        shaped mode. The count advances on the resolved action, a count above
        ``stall_limit`` ends the episode, done follows the v1 rule
        ``(~moved & game_over) | forced``, and the lanes clear on done only
        with ``reset_shaping``. A shaped window keeps no reward lanes:
        ``reward_sum`` is zeros and ``episode_return`` only resets on done.
      terminal_bonus: add the terminal bonus to the simple reward.

    Returns:
      ``(new_boards, new_score, new_steps, new_episode_return, reward_sum,
      done_count[, latch_state'][, stall_state'])``; ``reward_sum`` (-10 for
      an invalid move that does not end the episode, else the merge score,
      plus the bonus) and ``done_count`` are ``(B,)`` int32 window totals.
      On the card they are views of one allocation
      (:func:`rollout_output_layout`).

    A CPU tensor runs :func:`plain_env_rollout`; a CUDA tensor launches the
    kernel (and counts it in ``fused_env_rollout.launches``) or raises, at
    the layout :func:`rollout_geometry` picks from the batch, on PyTorch's
    current stream of the boards' device.
    """
    b, index = _check_rollout(boards, score, steps, episode_return, k_steps,
                              rng_bits, latch_state, stall_state, seed, step)
    kwargs = dict(seed=seed, step=step, terminal_bonus=terminal_bonus,
                  stall_limit=stall_limit, reset_shaping=reset_shaping)
    if index < 0:
        return plain_env_rollout(boards, score, steps, episode_return,
                                 k_steps, rng_bits, latch_state, stall_state,
                                 **kwargs)
    return launch_rollout(rollout_geometry(b)[0], b, index, boards, score,
                          steps, episode_return, k_steps, rng_bits,
                          latch_state, stall_state, **kwargs)


fused_env_rollout.launches = 0
