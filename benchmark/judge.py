"""The numbers the comparison with the plain reference reads: gaps of a
chosen action's Q-value, and gaps of norms taken leaf by leaf."""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence

import torch


def allowed_moves(legal: torch.Tensor, restrict: Optional[torch.Tensor]):
    """The actions a greedy choice may take: the legal ones where
    ``restrict`` holds (all lanes when it is None) and a move is legal,
    else all four."""
    lanes = (torch.ones(legal.shape[0], dtype=torch.bool,
                        device=legal.device)
             if restrict is None else restrict)
    use = lanes & legal.any(1)
    return torch.where(use[:, None], legal, torch.ones_like(legal))


def q_gaps(q: torch.Tensor, allowed: torch.Tensor, chosen: torch.Tensor):
    """How far the chosen action's Q-value lies below the best allowed one,
    a position each (``inf`` where the choice is not allowed)."""
    best = torch.where(allowed, q, -torch.inf).amax(1)
    pick = q.gather(1, chosen.view(-1, 1).to(torch.int64))[:, 0]
    ok = allowed.gather(1, chosen.view(-1, 1).to(torch.int64))[:, 0]
    return torch.where(ok, best - pick, torch.inf)


def first_choice(q: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, q, -torch.inf).argmax(1)


def leaf_gaps(candidate: Dict[str, float], reference: Dict[str, float],
              gradient: Dict[str, float]) -> Dict[str, float]:
    """Per leaf, the gap between two norms of it, over the reference's
    norm of that leaf or of the median leaf, whichever is larger. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out: they move by round-off alone."""
    g_med = statistics.median(gradient.values())
    r_med = statistics.median(reference.values())
    return {k: abs(candidate[k] - reference[k]) / max(reference[k], r_med)
            for k in reference if gradient[k] >= 1e-3 * g_med}


def worst(gaps: Dict[str, float]) -> float:
    return max(gaps.values()) if gaps else 0.0


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Float64 norms of a dict of tensors, read in one transfer."""
    names: Sequence[str] = list(tensors)
    vals = torch.stack([tensors[n].double().norm() for n in names]).tolist()
    return dict(zip(names, vals))
