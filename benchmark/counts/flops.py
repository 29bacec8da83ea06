"""Floating-point operations of the DQN's Q-network, counted from its
shapes (a multiply-add is 2)."""

from __future__ import annotations

KERNEL_SIZES = (1, 2, 3, 4)
CHANNELS = 16


def dqn_forward(cfg) -> int:
    """One board through the network: each block's four convolutions over
    the 16 cells (k * k taps each, ``features / 4`` filters), the dense
    layer and the head. 2,088,247,296 at features 2048, hidden 1024 and
    three blocks."""
    f, h = cfg["features"], cfg["hidden"]
    taps = sum(k * k for k in KERNEL_SIZES)
    conv = sum(2 * 16 * taps * (CHANNELS if i == 0 else f) * (f // 4)
               for i in range(cfg["num_blocks"]))
    return conv + 2 * 16 * f * h + 2 * h * cfg["actions"]


def dqn_update(cfg, batch: int) -> int:
    """One learner update: a train forward, a backward of twice its work
    and a target forward, a board each of the batch."""
    return 4 * batch * dqn_forward(cfg)
