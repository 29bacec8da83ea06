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


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("tpu2048_bucket_gather", "tpu2048_bucket_scatter"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("table_kernel.cu", _declare)


def _check_table(data: torch.Tensor, buckets: torch.Tensor) -> int:
    """Validate the table and the index vector; returns the batch."""
    if (data.dim() != 2 or data.shape[1] != ROW or data.shape[0] < 2
            or data.dtype != torch.int32 or not data.is_contiguous()):
        raise ValueError(
            f"data: expected contiguous (n_buckets + 1, {ROW}) torch.int32, "
            f"got {tuple(data.shape)} {data.dtype}")
    if (buckets.dim() != 1 or buckets.dtype != torch.int32
            or not buckets.is_contiguous()):
        raise ValueError(f"buckets: expected contiguous (B,) torch.int32, "
                         f"got {tuple(buckets.shape)} {buckets.dtype}")
    if buckets.device != data.device:
        raise ValueError(f"buckets are on {buckets.device}, data on "
                         f"{data.device}")
    if buckets.shape[0] == 0:
        raise ValueError("empty batch")
    return buckets.shape[0]


def _launch(name: str, data, buckets, other, b: int) -> None:
    device = data.device
    if device.type != "cuda":
        raise ValueError(f"no table kernel for device {device}")
    for t in (data, other):
        if t.data_ptr() % 16:
            raise ValueError("table kernels need 16-byte aligned tensors")
    err = getattr(LIBRARY.load(), name)(
        data.data_ptr(), buckets.data_ptr(), other.data_ptr(),
        data.shape[0], b, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def bucket_gather(data: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """Gather B bucket rows: ``(NB+1, 128), (B,) -> (B, 16, 8)`` int32.

    Port of ``tpu2048.ops.table_kernel.bucket_gather``; ``buckets`` lie in
    ``[0, NB)``. A CPU tensor runs :func:`plain_bucket_gather`; a CUDA
    tensor launches the kernel (and counts it in
    ``bucket_gather.launches``) or raises.
    """
    b = _check_table(data, buckets)
    if data.device.type == "cpu":
        return plain_bucket_gather(data, buckets)
    out = torch.empty((b, BUCKET, WIDTH), dtype=torch.int32,
                      device=data.device)
    _launch("tpu2048_bucket_gather", data, buckets, out, b)
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
    b = _check_table(data, buckets)
    if (rows.shape not in ((b, BUCKET, WIDTH), (b, ROW))
            or rows.dtype != torch.int32 or not rows.is_contiguous()):
        raise ValueError(f"rows: expected contiguous ({b}, {ROW}) "
                         f"torch.int32, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device != data.device:
        raise ValueError(f"rows are on {rows.device}, data on {data.device}")
    if data.device.type == "cpu":
        return plain_bucket_scatter_(data, buckets, rows)
    _launch("tpu2048_bucket_scatter", data, buckets, rows, b)
    bucket_scatter_.launches += 1
    return data


bucket_gather.launches = 0
bucket_scatter_.launches = 0
