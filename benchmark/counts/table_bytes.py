"""Bytes of the packed Q-table's bucket kernels (``csrc/table_kernel.cu``):
one bucket is a row of 128 int32 words (512 bytes). A gather reads a row
and an id for each lane and writes the row out; a scatter reads a row and
an id for each lane and writes the row into the table."""

from __future__ import annotations

ROW_BYTES = 128 * 4
ID_BYTES = 4


def bucket_call_bytes(lanes: int) -> int:
    """Bytes of one gather or one scatter call over ``lanes`` rows."""
    return lanes * (2 * ROW_BYTES + ID_BYTES)
