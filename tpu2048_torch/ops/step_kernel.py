"""The env-step kernel: one whole 2048 step per lane, the port of
:mod:`tpu2048.ops.pallas_step`'s ``_step_kernel``.

:func:`fused_env_step` launches the CUDA kernel in ``csrc/step_kernel.cu`` on
a CUDA tensor and runs :func:`plain_env_step`, the same function in plain
PyTorch, on a CPU tensor. There is no fallback from the card to the plain
version.

Layout: boards are cell-major ``(16, B)`` int8 (cell ``r*4+c`` is row
``r*4+c``). Randomness comes from the caller as ``(8, B)`` int32 rows that
hold the raw uint32 bit patterns, in the TPU kernel's row order: action-pick,
unused, spawn-pos, spawn-val, reset-p1, reset-p2, reset-v1, reset-v2. torch
has no unsigned 32-bit arithmetic on the CPU, so the plain version widens the
rows to int64 and masks them; the kernel reads them as ``uint32_t``.

The kernel is built with ``nvcc`` at first use, from the source in the
package, into ``build/`` beside the package, and loaded with ``ctypes``
(:mod:`tpu2048_torch.ops._build`).
"""

from __future__ import annotations

import ctypes

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


def _check(name, t, shape, dtype, device):
    if t.shape != shape or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} "
            f"{t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, boards on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.tpu2048_step_kernel
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("step_kernel.cu", _declare)


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
      [, ``(B,)`` bool][, ``(16, B)`` int8][, ``(4, B)`` int8].

    A CPU tensor runs :func:`plain_env_step`; a CUDA tensor launches the
    kernel (and counts it in ``fused_env_step.launches``) or raises.
    """
    device = boards.device
    if boards.dim() != 2 or boards.shape[0] != 16:
        raise ValueError(f"boards: expected (16, B), got {tuple(boards.shape)}")
    b = boards.shape[1]
    if b == 0:
        raise ValueError("empty batch")
    _check("boards", boards, (16, b), torch.int8, device)
    _check("actions", actions, (b,), torch.int32, device)
    _check("rng_bits", rng_bits, (8, b), torch.int32, device)
    if force_done is not None:
        _check("force_done", force_done, (b,), torch.bool, device)
    kwargs = dict(emit_pre_reset=emit_pre_reset, emit_legal=emit_legal)
    if device.type == "cpu":
        return plain_env_step(boards, actions, rng_bits, force_done, **kwargs)
    if device.type != "cuda":
        raise ValueError(f"no step kernel for device {device}")

    lib = LIBRARY.load()

    def lane(dtype):
        return torch.empty((b,), dtype=dtype, device=device)

    out_boards = torch.empty((16, b), dtype=torch.int8, device=device)
    score = lane(torch.int32)
    valid, done = lane(torch.bool), lane(torch.bool)
    max_exp, second_exp = lane(torch.int8), lane(torch.int8)
    game_over = lane(torch.bool) if force_done is not None else None
    pre_reset = (torch.empty((16, b), dtype=torch.int8, device=device)
                 if emit_pre_reset else None)
    legal = (torch.empty((4, b), dtype=torch.int8, device=device)
             if emit_legal else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.tpu2048_step_kernel(
        ptr(boards), ptr(actions), ptr(rng_bits), ptr(force_done),
        ptr(out_boards), ptr(score), ptr(valid), ptr(done), ptr(max_exp),
        ptr(second_exp), ptr(game_over), ptr(pre_reset), ptr(legal), b,
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    fused_env_step.launches += 1

    out = (out_boards, score, valid, done, max_exp, second_exp)
    for extra in (game_over, pre_reset, legal):
        if extra is not None:
            out += (extra,)
    return out


fused_env_step.launches = 0
