"""The n-tuple agent: the greedy afterstate policy and the TD(0) step of
Szubert & Jaskowski (IEEE CIG 2014), batched over lanes, on the network of
:mod:`tpu2048_torch.models.ntuple` and the kernels of
:mod:`tpu2048_torch.ops.ntuple_kernel`. It has no counterpart in the JAX
package.

A lane keeps its previous afterstate: the board its last move left, before
the spawn. One step of every lane (:func:`evaluate`, then :func:`learn`):

1. every move's afterstate, reward and legality, the value of each, and of
   the previous afterstate, all at the weights before the step;
2. the greedy action ``argmax(reward + V(after))`` over the legal moves,
   ties to the lowest index;
3. the previous afterstate's target: 0 where the previous step ended its
   game, else ``reward[a] + V(after[a])`` (gamma = 1);
4. each lane with a previous afterstate moves each of its ``L`` weights by
   ``alpha * (target - V(prev)) / L``. The updates of one step that land
   on one weight are averaged, not summed: with thousands of lanes, the
   weights that near-empty boards read are hit hundreds of times a step,
   and a sum at ``alpha`` 0.1 diverges.

The taken afterstate, and whether the env step after it ended the game,
become the lane's previous afterstate.

Played by search (:func:`expectimax_actions`), the network values the
leaves of a depth-D expectimax over the spawns' chance nodes, as the
published n-tuple agents are played; depth 1 is the greedy policy.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.models.ntuple import PATTERNS_4X6, NTupleNetwork
from tpu2048_torch.ops import ntuple_kernel as nk
from tpu2048_torch.ops.step_kernel import to_cell_major


@dataclasses.dataclass(frozen=True)
class NTupleConfig:
    """The network's patterns and the TD step size (TDL2048-Demo's 0.1,
    split over a board's lookups)."""

    patterns: tuple = PATTERNS_4X6
    alpha: float = 0.1


@dataclasses.dataclass
class Lanes:
    """Each lane's previous afterstate: the board, whether there is one
    (not before a lane's first move), and whether the env step after it
    ended the game."""

    prev_after: torch.Tensor  # (16, B) int8 cell-major
    prev_valid: torch.Tensor  # (B,) bool
    prev_terminal: torch.Tensor  # (B,) bool


def init_lanes(batch: int, device) -> Lanes:
    def zero(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Lanes(prev_after=zero((16, batch), torch.int8),
                 prev_valid=zero((batch,), torch.bool),
                 prev_terminal=zero((batch,), torch.bool))


def evaluate(net: NTupleNetwork, boards: torch.Tensor,
             lanes: Lanes) -> nk.Afterstates:
    """Steps 1-3 for the ``(16, B)`` cell-major boards (one kernel launch on
    the card)."""
    with annotate("ntuple.evaluate"):
        return nk.afterstate_values(boards, lanes.prev_after,
                                    lanes.prev_valid, lanes.prev_terminal,
                                    net.weights, net.maps)


def learn(net: NTupleNetwork, lanes: Lanes, out: nk.Afterstates,
          alpha: float) -> None:
    """Step 4, in place on the network's weights."""
    with annotate("ntuple.learn"):
        nk.td_update_(net.weights, net.counts, net.maps, lanes.prev_after,
                      lanes.prev_valid, out.v_prev, out.target, alpha)


def greedy_actions(net: NTupleNetwork, boards: torch.Tensor) -> torch.Tensor:
    """``(B,)`` int32 greedy afterstate actions of ``(B, 4, 4)`` boards (0
    where no move is legal)."""
    lanes = init_lanes(boards.shape[0], boards.device)
    return evaluate(net, to_cell_major(boards.to(torch.int8)), lanes).action


def expectimax_search(net: NTupleNetwork, boards: torch.Tensor,
                      depth: int) -> nk.Search:
    """Depth-``depth`` expectimax, depth 2 or 3, on ``(B, 4, 4)`` boards
    (:func:`tpu2048_torch.ops.ntuple_kernel.search_values`: two launches on
    the card), in the span ``ntuple.search``: the ``(4, B)`` root values
    and the ``(B,)`` int32 actions. Depth 1 is :func:`greedy_actions`."""
    with annotate("ntuple.search"):
        return nk.search_values(to_cell_major(boards.to(torch.int8)),
                                net.weights, net.maps, depth)


def expectimax_actions(net: NTupleNetwork, boards: torch.Tensor,
                       depth: int) -> torch.Tensor:
    """:func:`expectimax_search`'s ``(B,)`` int32 actions."""
    return expectimax_search(net, boards, depth).action
