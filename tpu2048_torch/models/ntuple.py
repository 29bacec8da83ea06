"""The n-tuple network: a value function of the board read from lookup
tables, one a pattern of cells, each read under the board's 8 symmetries.

This is the network of Szubert & Jaskowski ("Temporal Difference Learning
of N-Tuple Networks for the Game 2048", IEEE CIG 2014) at the 4x6-tuple
set of Yeh et al. ("Multistage Temporal Difference Learning for 2048-like
Games", IEEE TCIAIG 2017, arXiv:1606.07374): patterns of row-major cells,
cell 0 at the top left. It has no counterpart in the JAX package.

A pattern of ``k`` cells has a table of ``16**k`` float32 weights, indexed
by ``sum_j e[cell_j] * 16**j``, ``e`` a cell's tile exponent clipped at 15.
The value of a board is the sum over the patterns and the 8 symmetries
(4 rotations, with and without a reflection) of the weight that the
pattern reads on the transformed board: ``len(patterns) * 8`` lookups. A
symmetry ``s`` reads board cell ``s[x]`` at cell ``x``, so a pattern read on
the transformed board reads the board's cells ``s[cell_j]``: the
:func:`index_maps`. Lookup ``l`` reads pattern ``l // 8`` at row ``l`` of the
maps; the tables are one contiguous ``(n_patterns, 16**k)`` tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# Yeh et al.'s 4x6-tuple network (TDL2048-Demo's patterns).
PATTERNS_4X6 = ((0, 1, 2, 3, 4, 5), (4, 5, 6, 7, 8, 9),
                (0, 1, 2, 4, 5, 6), (4, 5, 6, 8, 9, 10))
SYMMETRIES = 8
MAX_EXPONENT = 15


def symmetries() -> np.ndarray:
    """``(8, 16)``: row ``s`` gives, for each cell, the cell of the board
    that the ``s``-th transform puts there (4 rotations, then the same of
    the transposed board)."""
    grid = np.arange(16).reshape(4, 4)
    out = [np.rot90(g, k) for g in (grid, grid.T) for k in range(4)]
    return np.stack([t.reshape(16) for t in out])


def index_maps(patterns: Sequence[Sequence[int]]) -> np.ndarray:
    """``(len(patterns) * 8, k)``: the board cells lookup ``l`` reads, in
    the order of the pattern's cells."""
    sym = symmetries()
    return np.array([[sym[s][c] for c in p] for p in patterns
                     for s in range(SYMMETRIES)], np.int64)


def check_patterns(patterns) -> Tuple[Tuple[int, ...], ...]:
    """The patterns as tuples; raises unless they are non-empty and of one
    size ``k`` in ``[1, 7]`` (a table of ``16**k`` weights), of distinct
    cells in ``[0, 16)``."""
    patterns = tuple(tuple(int(c) for c in p) for p in patterns)
    if not patterns or len({len(p) for p in patterns}) != 1:
        raise ValueError(f"patterns must share one size: {patterns}")
    k = len(patterns[0])
    if not 1 <= k <= 7:
        raise ValueError(f"a pattern has 1 to 7 cells, not {k}")
    for p in patterns:
        if len(set(p)) != k or not all(0 <= c < 16 for c in p):
            raise ValueError(f"bad pattern {p}")
    return patterns


def lut_indices(boards: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """``(B, L)`` int64 indices into the flat weights of the ``(B, 16)``
    boards' ``L`` lookups: ``maps`` is :func:`index_maps` as a tensor on the
    boards' device, of any integer type."""
    maps = maps.to(torch.int64)
    n, k = maps.shape
    e = boards.to(torch.int64).clamp(0, MAX_EXPONENT)
    cells = e[:, maps]  # (B, L, k)
    shifts = 4 * torch.arange(k, device=boards.device)
    local = (cells << shifts).sum(-1)
    base = (torch.arange(n, device=boards.device) // SYMMETRIES) << (4 * k)
    return local + base


class NTupleNetwork:
    """The patterns, their index maps and the weights, ``(n_patterns,
    16**k)`` float32 on ``device``, zero unless given."""

    def __init__(self, patterns=PATTERNS_4X6, device="cpu",
                 weights: torch.Tensor = None):
        self.patterns = check_patterns(patterns)
        self.k = len(self.patterns[0])
        self.device = torch.device(device)
        self.maps = torch.from_numpy(index_maps(self.patterns)).to(
            self.device, torch.uint8)
        shape = (len(self.patterns), 16 ** self.k)
        if weights is None:
            weights = torch.zeros(shape, dtype=torch.float32,
                                  device=self.device)
        if tuple(weights.shape) != shape or weights.dtype != torch.float32:
            raise ValueError(f"weights: expected {shape} float32, got "
                             f"{tuple(weights.shape)} {weights.dtype}")
        self.weights = weights.to(self.device).contiguous()
        self._counts = None

    @property
    def counts(self):
        """The TD-update kernel's scratch on the card: int32 zeros of the
        weights' shape, made at first use (None on the CPU)."""
        if self._counts is None and self.weights.is_cuda:
            self._counts = torch.zeros(self.weights.shape, dtype=torch.int32,
                                       device=self.device)
        return self._counts

    @property
    def lookups(self) -> int:
        return self.maps.shape[0]

    def value(self, boards: torch.Tensor) -> torch.Tensor:
        """``(B,)`` float32 values of ``(B, 16)`` or ``(B, 4, 4)`` exponent
        boards, in plain ops."""
        idx = lut_indices(boards.reshape(-1, 16), self.maps)
        return self.weights.view(-1)[idx].sum(1)

    def save(self, path: str) -> None:
        """The patterns and the weights as an ``.npz``."""
        np.savez(path, patterns=np.array(self.patterns, np.int64),
                 weights=self.weights.cpu().numpy())

    @classmethod
    def load(cls, path: str, device="cpu") -> "NTupleNetwork":
        with np.load(path) as f:
            return cls(f["patterns"].tolist(), device,
                       torch.from_numpy(f["weights"]))
