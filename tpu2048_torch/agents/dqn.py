"""DQN agent configuration, from :mod:`tpu2048.agents.dqn`.

Only :class:`DQNConfig` is ported so far, because :func:`tpu2048_torch.
models.dqn.create_model` reads it; the agent's functions come with the
training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Hyperparameters; defaults = the run of record (Dqn8:249, Dqn8:203)."""

    gamma: float = 0.99
    epsilon: float = 0.9
    epsilon_min: float = 0.001
    epsilon_decay: float = 0.9999
    decay_episodes: int = 200  # kept for config parity (epsilon_decay1)
    batch_size: int = 64
    memory_size: int = 50_000
    alpha: float = 0.0
    beta: float = 1.0
    beta_increment: float = 1e-5
    learning_rate: float = 5e-5
    lr_decay_factor: float = 0.98  # Dqn8:302
    lr_min: float = 1e-6
    lr_decay_tile: int = 1024  # remember() arms the hook at >=1024 (Dqn8:284)
    priority_epsilon: float = 1e-6  # Dqn8:97
    dedup: bool = True
    # Network (Dqn8:209-246).
    features: int = 2048
    hidden: int = 1024
    dropout: float = 0.5
    num_blocks: int = 3
    bf16: bool = True
    fused_conv: bool = False  # single-4x4-conv fusion; not yet ported
