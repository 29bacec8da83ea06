"""Bucket gather and bucket scatter on the packed Q-table, the port of
:mod:`tpu2048.ops.table_kernel`.

Layout: one bucket is one 128-word row of the ``(n_buckets + 1, 128)``
table; slot ``j`` of a bucket holds words ``[8j, 8j + 8)`` as ``[key_lo,
key_hi, q0..q3 (float32 bits), pad, pad]``. Row ``n_buckets`` is a
write-only trash row: the updates with nothing to write go there, so the
scatter has a fixed shape. Words are int32 storage of the raw uint32
patterns (torch has no unsigned 32-bit arithmetic on the CPU).

:func:`bucket_gather` and :func:`bucket_scatter_` launch the CUDA kernels of
``csrc/table_kernel.cu`` on CUDA tensors and run :func:`plain_bucket_gather`
and :func:`plain_bucket_scatter_`, the same functions in plain PyTorch, on
CPU tensors. There is no fallback from the card to the plain version.
The scatter writes into the table it is given: the JAX kernel's donated,
aliased output becomes an update in place, so a step never copies the table.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tpu2048_torch.ops._build import CudaLibrary

#: Slots per bucket; equals ``tpu2048_torch.agents.tabular.PROBES``.
BUCKET = 16
#: Words per slot: ``[key_lo, key_hi, q0..q3, pad, pad]``.
WIDTH = 8
#: Words per bucket row.
ROW = BUCKET * WIDTH


def plain_bucket_gather(data: torch.Tensor, buckets: torch.Tensor):
    """``data[:nb][buckets]`` as ``(B, 16, 8)`` (``bucket_gather_xla``)."""
    nb = data.shape[0] - 1
    return data[:nb][buckets].view(buckets.shape[0], BUCKET, WIDTH)


def plain_bucket_scatter_(data: torch.Tensor, buckets: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """``data[buckets] = rows`` in place (``bucket_scatter_xla``); returns
    ``data``. Writes to the trash row may land in any order."""
    data[buckets] = rows.reshape(rows.shape[0], ROW)
    return data


#: Launch geometry, mirrored from ``csrc/table_kernel.cu`` (a test reads the
#: constants from the source): blocks of WARPS warps, each warp with a ring
#: of RING_STAGES stages of STAGE_ROWS rows in shared memory, and a
#: persistent grid of at most MAX_BLOCKS blocks (two on each of the H100's
#: 132 SMs).
WARPS = 4
STAGE_ROWS = 8
RING_STAGES = 3
MAX_BLOCKS = 264


class Geometry(NamedTuple):
    blocks: int
    warps: int
    stages: int
    rows_per_stage: int
    shared_bytes: int


def launch_geometry(batch: int) -> Geometry:
    """The launch of either kernel at ``batch`` rows. Chunk ``c`` is rows
    ``[c * rows_per_stage, (c + 1) * rows_per_stage)``. Warp ``w`` of block
    ``b`` runs ring ``r = w * blocks + b``, which takes chunks ``r, r +
    rings, ...`` (``rings = blocks * warps``) and puts its ``k``-th into
    stage ``k % stages``. Shared memory holds the rings and one 8-byte
    mbarrier a stage."""
    chunks = -(-batch // STAGE_ROWS)
    return Geometry(blocks=min(chunks, MAX_BLOCKS), warps=WARPS,
                    stages=RING_STAGES, rows_per_stage=STAGE_ROWS,
                    shared_bytes=WARPS * RING_STAGES
                    * (STAGE_ROWS * ROW * 4 + 8))


#: The C entries' arguments: data, buckets, out or rows (pointers), n_rows
#: (64-bit), batch, device, stream (a pointer).
ARGTYPES = ((ctypes.c_void_p,) * 3
            + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def _declare(lib: ctypes.CDLL) -> None:
    for fn in (lib.tpu2048_bucket_gather, lib.tpu2048_bucket_scatter):
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("table_kernel.cu", _declare)
# The two C entries, resolved once when the library loads.
_entries: Optional[tuple] = None


def _load_entries() -> tuple:
    global _entries
    lib = LIBRARY.load()
    _entries = (lib.tpu2048_bucket_gather, lib.tpu2048_bucket_scatter)
    return _entries


def _check_table(data: torch.Tensor,
                 buckets: torch.Tensor) -> Tuple[int, int, int]:
    """Validate the table and the index vector; returns the batch, the
    table's rows and the CUDA device's index (-1 for CPU tensors)."""
    shape = data.shape
    if (len(shape) != 2 or shape[1] != ROW or shape[0] < 2
            or data.dtype is not torch.int32 or not data.is_contiguous()):
        raise ValueError(
            f"data: expected contiguous (n_buckets + 1, {ROW}) torch.int32, "
            f"got {tuple(shape)} {data.dtype}")
    bshape = buckets.shape
    if (len(bshape) != 1 or buckets.dtype is not torch.int32
            or not buckets.is_contiguous()):
        raise ValueError(f"buckets: expected contiguous (B,) torch.int32, "
                         f"got {tuple(bshape)} {buckets.dtype}")
    if data.is_cuda:
        index = data.get_device()
        same = buckets.get_device() == index and buckets.is_cuda
    else:
        index = -1
        same = buckets.device == data.device
    if not same:
        raise ValueError(f"buckets are on {buckets.device}, data on "
                         f"{data.device}")
    if index < 0 and data.device.type != "cpu":
        raise ValueError(f"no table kernel for device {data.device}")
    if not bshape[0]:
        raise ValueError("empty batch")
    return bshape[0], shape[0], index


def _launch(entry: int, data, buckets, other, b: int, n_rows: int,
            index: int) -> None:
    """Launch C entry ``entry`` (0 gather, 1 scatter) on PyTorch's current
    stream of device ``index``: ``torch.accelerator.current_stream`` follows
    ``torch.cuda.stream`` and graph capture, as ``torch.cuda.current_stream``
    does, without building a ``torch.cuda.Stream``."""
    data_ptr, other_ptr = data.data_ptr(), other.data_ptr()
    if (data_ptr | other_ptr) & 15:
        raise ValueError("table kernels need 16-byte aligned tensors")
    fn = (_entries or _load_entries())[entry]
    err = fn(data_ptr, buckets.data_ptr(), other_ptr, n_rows, b, index,
             torch.accelerator.current_stream(index).native_handle)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def bucket_gather(data: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """Gather B bucket rows: ``(NB+1, 128), (B,) -> (B, 16, 8)`` int32.

    Port of ``tpu2048.ops.table_kernel.bucket_gather``; ``buckets`` lie in
    ``[0, NB)``. A CPU tensor runs :func:`plain_bucket_gather`; a CUDA
    tensor launches the kernel (and counts it in
    ``bucket_gather.launches``) or raises.
    """
    b, n_rows, index = _check_table(data, buckets)
    if index < 0:
        return plain_bucket_gather(data, buckets)
    out = data.new_empty(b, BUCKET, WIDTH)
    _launch(0, data, buckets, out, b, n_rows, index)
    bucket_gather.launches += 1
    return out


def bucket_scatter_(data: torch.Tensor, buckets: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Write B bucket images in place: ``data[buckets[i]] = rows[i]``;
    returns ``data``.

    Port of ``tpu2048.ops.table_kernel.bucket_scatter``. ``buckets`` lie in
    ``[0, NB]`` and are distinct below the trash row ``NB``; ``rows`` is
    ``(B, 16, 8)`` or ``(B, 128)`` int32. A CPU tensor runs
    :func:`plain_bucket_scatter_`; a CUDA tensor launches the kernel (and
    counts it in ``bucket_scatter_.launches``) or raises.
    """
    b, n_rows, index = _check_table(data, buckets)
    if (rows.shape not in ((b, BUCKET, WIDTH), (b, ROW))
            or rows.dtype is not torch.int32 or not rows.is_contiguous()):
        raise ValueError(f"rows: expected contiguous ({b}, {ROW}) "
                         f"torch.int32, got {tuple(rows.shape)} {rows.dtype}")
    same = (rows.get_device() == index if index >= 0
            else rows.device == data.device)
    if not same:
        raise ValueError(f"rows are on {rows.device}, data on {data.device}")
    if index < 0:
        return plain_bucket_scatter_(data, buckets, rows)
    _launch(1, data, buckets, rows, b, n_rows, index)
    bucket_scatter_.launches += 1
    return data


bucket_gather.launches = 0
bucket_scatter_.launches = 0
