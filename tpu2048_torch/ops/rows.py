"""Row slide+merge, the port of :mod:`tpu2048.ops.rows`.

Tiles are log2 exponents stored as ``int8`` (0 = empty). The arithmetic runs
in int32 and the rows are stored back as int8.
"""

from __future__ import annotations

import torch

_BUBBLE_PAIRS = ((0, 1), (1, 2), (2, 3), (0, 1), (1, 2), (0, 1))


def _compact_left(cells):
    """Stable zeros-right compaction of four lane tensors (sorting network)."""
    cells = list(cells)
    for i, j in _BUBBLE_PAIRS:
        a, b = cells[i], cells[j]
        swap = (a == 0) & (b != 0)
        cells[i] = torch.where(swap, b, a)
        cells[j] = torch.where(swap, a, b)
    return cells


def merge_rows_left(rows: torch.Tensor):
    """Slide+merge ``(..., 4)`` int8 rows to the left.

    Port of ``tpu2048.ops.rows.merge_rows_left``: a cell made by a merge
    does not merge again in the same move.

    Returns ``(new_rows, score, moved)``: ``(..., 4)`` int8, ``(...,)``
    int32 (sum of the created tile values) and ``(...,)`` bool.
    """
    r = rows.to(torch.int32)
    x0, x1, x2, x3 = _compact_left(r.unbind(-1))
    m01 = (x0 == x1) & (x0 > 0)
    m12 = (x1 == x2) & (x1 > 0) & ~m01
    m23 = (x2 == x3) & (x2 > 0) & ~m12
    zero = torch.zeros_like(x0)
    y0 = x0 + m01.to(torch.int32)
    y1 = torch.where(m01, zero, x1 + m12.to(torch.int32))
    y2 = torch.where(m12, zero, x2 + m23.to(torch.int32))
    y3 = torch.where(m23, zero, x3)
    new_rows = torch.stack(_compact_left((y0, y1, y2, y3)), dim=-1)

    def _val(mask, exp):
        return torch.where(mask, torch.ones_like(exp) << (exp + 1), zero)

    score = _val(m01, x0) + _val(m12, x1) + _val(m23, x2)
    moved = (new_rows != r).any(dim=-1)
    return new_rows.to(torch.int8), score, moved
