"""The n-tuple network's kernels: the afterstate values of every move of
every lane, and the TD(0) update of the lanes' previous afterstates.

:func:`afterstate_values` and :func:`td_update_` launch the CUDA kernels of
``csrc/ntuple_kernel.cu`` on CUDA tensors and run :func:`plain_afterstate_
values` and :func:`plain_td_update_`, the same functions in plain PyTorch,
on CPU tensors. There is no fallback from the card to the plain versions.
They replace no kernel of the JAX package, which has no n-tuple network.

Boards are cell-major ``(16, B)`` int8 exponents, as the fast env holds
them. The weights are :class:`tpu2048_torch.models.ntuple.NTupleNetwork`'s
``(n_patterns, 16**k)`` float32 tensor and ``maps`` its ``(L, k)`` uint8
index maps (``L = 8 * n_patterns``, at most 64; ``k`` at most 7).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.ops._build import CudaLibrary
from tpu2048_torch.ops.step_kernel import (_check, _device_index,
                                           from_cell_major)

# Mirrors of csrc/ntuple_kernel.cu's limits (kMaxLookups, kMaxCells).
MAX_LOOKUPS = 64
MAX_CELLS = 7
SYMMETRIES = 8  # lookups a pattern
MAX_EXPONENT = 15  # a cell's exponent in an index is clipped here


def lut_indices(boards: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """``(B, L)`` int64 indices into the flat weights of the ``(B, 16)``
    boards' ``L`` lookups: ``maps`` is :func:`tpu2048_torch.models.ntuple.
    index_maps` as a tensor on the boards' device, of any integer type."""
    maps = maps.to(torch.int64)
    n, k = maps.shape
    e = boards.to(torch.int64).clamp(0, MAX_EXPONENT)
    cells = e[:, maps]  # (B, L, k)
    shifts = 4 * torch.arange(k, device=boards.device)
    local = (cells << shifts).sum(-1)
    base = (torch.arange(n, device=boards.device) // SYMMETRIES) << (4 * k)
    return local + base


class Afterstates(NamedTuple):
    """One evaluation of every lane, at the weights before the step."""

    after: torch.Tensor  # (4, 16, B) int8: each move's afterstate, no spawn
    reward: torch.Tensor  # (4, B) int32: each move's merge reward
    legal: torch.Tensor  # (4, B) bool: the move changes the board
    values: torch.Tensor  # (4, B) f32: V(after), -inf where illegal
    v_prev: torch.Tensor  # (B,) f32: V(previous afterstate), 0 without one
    action: torch.Tensor  # (B,) int32: argmax(reward + V), lowest on ties
    target: torch.Tensor  # (B,) f32: the previous afterstate's TD target
    chosen: torch.Tensor  # (16, B) int8: the afterstate of ``action``


def _values(weights, maps, boards_flat):
    """``(N,)`` values of ``(N, 16)`` boards."""
    return weights.view(-1)[lut_indices(boards_flat, maps)].sum(1)


def plain_afterstate_values(boards, prev_after, prev_valid, prev_terminal,
                            weights, maps) -> Afterstates:
    """The afterstate kernel's function in plain PyTorch: arguments and
    outputs are those of :func:`afterstate_values`."""
    b = boards.shape[1]
    after, reward, legal = board_ops.move_all(from_cell_major(boards))
    after = after.reshape(4, b, 16)
    values = _values(weights, maps, after.reshape(4 * b, 16)).view(4, b)
    values = torch.where(legal, values, -torch.inf)
    prev = from_cell_major(prev_after).reshape(b, 16)
    v_prev = torch.where(prev_valid, _values(weights, maps, prev), 0.0)
    q = torch.where(legal, reward.to(torch.float32) + values, -torch.inf)
    best, action = q.max(0)  # the first maximum
    ends = prev_terminal | ~legal.any(0)
    target = torch.where(ends, 0.0, best)
    lanes = torch.arange(b, device=boards.device)
    return Afterstates(
        after=after.transpose(1, 2).contiguous(), reward=reward, legal=legal,
        values=values, v_prev=v_prev, action=action.to(torch.int32),
        target=target, chosen=after[action, lanes].T.contiguous())


def plain_td_update_(weights, maps, prev_after, prev_valid, v_prev, target,
                     alpha: float) -> torch.Tensor:
    """The TD-update kernel's function in plain PyTorch, in place: each
    lane with a previous afterstate adds ``alpha * (target - v_prev) / L``
    at each of its lookups; the additions that land on one weight are
    averaged. Returns ``weights``."""
    n = maps.shape[0]
    b = prev_after.shape[1]
    prev = from_cell_major(prev_after).reshape(b, 16)[prev_valid]
    idx = lut_indices(prev, maps).flatten()
    step = alpha * (target - v_prev) / n
    adds = step[prev_valid].repeat_interleave(n)
    hit, where, count = torch.unique(idx, return_inverse=True,
                                     return_counts=True)
    total = torch.zeros(hit.shape, dtype=weights.dtype,
                        device=weights.device).index_add_(0, where, adds)
    flat = weights.view(-1)
    flat[hit] += total / count.to(weights.dtype)
    return weights


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.tpu2048_ntuple_value
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tpu2048_ntuple_update
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


# The source includes step_kernel.cu (its row merge): the build's name
# hashes both.
LIBRARY = CudaLibrary("ntuple_kernel.cu", _declare)


def _check_net(weights, maps, boards, index):
    """Raise unless the weights and maps fit the kernels and lie with the
    boards; returns ``(L, k)``."""
    n, k = maps.shape
    if not (0 < n <= MAX_LOOKUPS and n % 8 == 0 and 0 < k <= MAX_CELLS):
        raise ValueError(f"maps: {n} lookups of {k} cells do not fit")
    _check("maps", maps, (n, k), torch.uint8, boards, index)
    _check("weights", weights, (n // 8, 16 ** k), torch.float32, boards,
           index)
    return n, k


def _check_lanes(boards, **lanes):
    shape = boards.shape
    if len(shape) != 2 or shape[0] != 16 or not shape[1]:
        raise ValueError(f"boards: expected (16, B), got {tuple(shape)}")
    b = shape[1]
    index = _device_index(boards, "n-tuple")
    _check("boards", boards, shape, torch.int8, boards, index)
    kinds = dict(prev_after=((16, b), torch.int8),
                 prev_valid=((b,), torch.bool),
                 prev_terminal=((b,), torch.bool),
                 v_prev=((b,), torch.float32), target=((b,), torch.float32))
    for name, t in lanes.items():
        _check(name, t, *kinds[name], boards, index)
    return b, index


def _stream(index):
    return torch.accelerator.current_stream(index).native_handle


def afterstate_values(boards, prev_after, prev_valid, prev_terminal,
                      weights, maps) -> Afterstates:
    """Evaluate every lane: its four afterstates, their rewards, legality
    and values, the value of its previous afterstate ``prev_after`` (where
    ``prev_valid``), the greedy action and the previous afterstate's TD
    target (0 where ``prev_terminal``: the previous step ended its game).

    A CPU tensor runs :func:`plain_afterstate_values`; a CUDA tensor
    launches the kernel on PyTorch's current stream (and counts it in
    ``afterstate_values.launches``) or raises."""
    b, index = _check_lanes(boards, prev_after=prev_after,
                            prev_valid=prev_valid,
                            prev_terminal=prev_terminal)
    n, k = _check_net(weights, maps, boards, index)
    if index < 0:
        return plain_afterstate_values(boards, prev_after, prev_valid,
                                       prev_terminal, weights, maps)
    out = Afterstates(
        after=boards.new_empty((4, 16, b)),
        reward=torch.empty((4, b), dtype=torch.int32, device=boards.device),
        legal=torch.empty((4, b), dtype=torch.bool, device=boards.device),
        values=weights.new_empty((4, b)), v_prev=weights.new_empty(b),
        action=torch.empty(b, dtype=torch.int32, device=boards.device),
        target=weights.new_empty(b), chosen=boards.new_empty((16, b)))
    err = LIBRARY.load().tpu2048_ntuple_value(
        boards.data_ptr(), prev_after.data_ptr(), prev_valid.data_ptr(),
        prev_terminal.data_ptr(), weights.data_ptr(), maps.data_ptr(), n, k,
        *(t.data_ptr() for t in out), b, index, _stream(index))
    if err != 0:
        raise RuntimeError(f"afterstate kernel launch failed: CUDA error "
                           f"{err}")
    afterstate_values.launches += 1
    return out


afterstate_values.launches = 0


def td_update_(weights, counts, maps, prev_after, prev_valid, v_prev,
               target, alpha: float) -> torch.Tensor:
    """The TD(0) update of the lanes' previous afterstates, in place: see
    :func:`plain_td_update_`. ``counts`` is int32 scratch of the weights'
    shape, all zero, which the kernel leaves zero (None on the CPU).

    A CPU tensor runs :func:`plain_td_update_`; a CUDA tensor launches the
    kernel's three phases on PyTorch's current stream (and counts three in
    ``td_update_.launches``) or raises. Returns ``weights``."""
    b, index = _check_lanes(prev_after, prev_valid=prev_valid,
                            v_prev=v_prev, target=target)
    n, k = _check_net(weights, maps, prev_after, index)
    if index < 0:
        return plain_td_update_(weights, maps, prev_after, prev_valid,
                                v_prev, target, alpha)
    _check("counts", counts, tuple(weights.shape), torch.int32, prev_after,
           index)
    err = LIBRARY.load().tpu2048_ntuple_update(
        weights.data_ptr(), counts.data_ptr(), maps.data_ptr(), n, k,
        prev_after.data_ptr(), prev_valid.data_ptr(), v_prev.data_ptr(),
        target.data_ptr(), alpha, b, index, _stream(index))
    if err != 0:
        raise RuntimeError(f"TD-update kernel launch failed: CUDA error "
                           f"{err}")
    td_update_.launches += 3
    return weights


td_update_.launches = 0
