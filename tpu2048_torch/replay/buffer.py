"""Device-resident replay memory (uniform and prioritized), the port of
:mod:`tpu2048.replay.buffer`.

The buffer is a dataclass of tensors on one device. Every operation is a
few tensor ops that never wait for the device: a batched insert compacted
by a cumsum of the mask, uniform or priority^alpha sampling, a priority
update, and the pruning of the lowest-scoring episodes. Semantics are the
JAX module's: transitions store ``next_board``; rejected lanes consume no
slot; new entries get ``max_priority``; ``prune_low_score_episodes`` keeps
the trailing incomplete episode and moves priorities with their
transitions.

Each array has one row more than the capacity: the last row is a
write-only trash row that rejected lanes are scattered into, where the JAX
module drops them with ``mode="drop"``. It is never read.

The JAX package's ``replay/sharded.py`` (a leading shard axis) is not
ported: the port keeps one flat buffer, so its total size is ``size``. Its
``ReplayConfig``, which nothing reads, is not ported either: the DQN's
replay settings are fields of ``DQNConfig``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ReplayBuffer:
    boards: torch.Tensor  # (C + 1, 4, 4) int8
    next_boards: torch.Tensor  # (C + 1, 4, 4) int8
    actions: torch.Tensor  # (C + 1,) int8
    rewards: torch.Tensor  # (C + 1,) f32
    dones: torch.Tensor  # (C + 1,) bool
    priorities: torch.Tensor  # (C + 1,) f32
    max_priority: torch.Tensor  # () f32
    ptr: torch.Tensor  # () int32 next write slot
    size: torch.Tensor  # () int32 valid entries

    @property
    def capacity(self) -> int:
        return self.boards.shape[0] - 1


# The per-slot arrays, each with the trash row.
ARRAYS = ("boards", "next_boards", "actions", "rewards", "dones",
          "priorities")


def replay_init(capacity: int, device="cpu") -> ReplayBuffer:
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    rows = capacity + 1
    return ReplayBuffer(
        boards=zeros((rows, 4, 4), torch.int8),
        next_boards=zeros((rows, 4, 4), torch.int8),
        actions=zeros((rows,), torch.int8),
        rewards=zeros((rows,), torch.float32),
        dones=zeros((rows,), torch.bool),
        priorities=zeros((rows,), torch.float32),
        max_priority=torch.ones((), dtype=torch.float32, device=device),
        ptr=zeros((), torch.int32),
        size=zeros((), torch.int32),
    )


def replay_add(buffer: ReplayBuffer, boards, actions, rewards, dones,
               next_boards, mask) -> ReplayBuffer:
    """Insert the transitions whose ``mask`` is True, compacted, in place.

    Masked-out entries (the actor's dedup skips, Dqn8:283-297) consume no
    slots. New entries get ``max_priority`` (Dqn8:44-46). Ring semantics:
    the oldest entries are overwritten once full. Returns ``buffer``.
    """
    c = buffer.capacity
    m = mask.to(torch.int32)
    offsets = torch.cumsum(m, 0, dtype=torch.int32) - 1
    n_added = m.sum(dtype=torch.int32)
    pos = torch.where(mask, (buffer.ptr + offsets) % c, c).to(torch.int64)
    buffer.boards[pos] = boards.to(torch.int8)
    buffer.next_boards[pos] = next_boards.to(torch.int8)
    buffer.actions[pos] = actions.to(torch.int8)
    buffer.rewards[pos] = rewards.to(torch.float32)
    buffer.dones[pos] = dones
    buffer.priorities[pos] = buffer.max_priority
    buffer.ptr = (buffer.ptr + n_added) % c
    buffer.size = torch.clamp_max(buffer.size + n_added, c)
    return buffer


def _probabilities(buffer: ReplayBuffer, alpha: float) -> torch.Tensor:
    """Per-slot sampling probabilities (Dqn8:75-83), ``(C,)`` f32."""
    c = buffer.capacity
    in_range = (torch.arange(c, device=buffer.size.device)
                < buffer.size).to(torch.float32)
    if alpha == 0.0:
        p = in_range
    else:
        p = torch.where(in_range > 0, buffer.priorities[:c] ** alpha, 0.0)
        # The reference falls back to uniform when all priorities are 0.
        p = torch.where(p.sum() > 0, p, in_range)
    return p / torch.clamp_min(p.sum(), 1e-30)


def sample_indices(buffer: ReplayBuffer, batch_size: int, alpha: float,
                   generator: torch.Generator) -> torch.Tensor:
    """``(batch_size,)`` int64 slots drawn from ``generator``: uniform over
    ``[0, size)`` at ``alpha == 0`` (floor of a float64 uniform times the
    size, so no host read of ``size``), else by priority^alpha."""
    if alpha == 0.0:
        u = torch.rand(batch_size, dtype=torch.float64, generator=generator,
                       device=generator.device).to(buffer.size.device)
        n = torch.clamp_min(buffer.size, 1)
        return torch.minimum((u * n).to(torch.int64), n - 1)
    p = _probabilities(buffer, alpha)
    return torch.multinomial(p.to(generator.device), batch_size,
                             replacement=True, generator=generator
                             ).to(buffer.size.device)


def replay_sample(buffer: ReplayBuffer, batch_size: int, alpha: float, beta,
                  indices: torch.Tensor):
    """Sample a batch (Dqn8:67-95) at ``indices``, injected by the caller
    (from :func:`sample_indices`, or the reference's own draw in a test).

    Returns ``(batch dict, indices, is_weights)``; ``is_weights`` are 1 at
    ``alpha == 0`` and otherwise normalized by the batch max, as in the
    reference. The batch's ``action`` is int64.
    """
    indices = indices.to(torch.int64)
    if alpha == 0.0:
        w = torch.ones((batch_size,), dtype=torch.float32,
                       device=indices.device)
    else:
        p = _probabilities(buffer, alpha)
        n = torch.clamp_min(buffer.size.to(torch.float32), 1.0)
        w = (n * p[indices]) ** (-beta)
        w = w / torch.clamp_min(w.max(), 1e-30)
    batch = {
        "board": buffer.boards[indices],
        "action": buffer.actions[indices].to(torch.int64),
        "reward": buffer.rewards[indices],
        "done": buffer.dones[indices],
        "next_board": buffer.next_boards[indices],
    }
    return batch, indices, w


def replay_update_priorities(buffer: ReplayBuffer, indices, td_errors,
                             epsilon: float = 1e-6) -> ReplayBuffer:
    """``priority[i] = |td| + eps``; bump ``max_priority`` (Dqn8:97-104).
    In place; returns ``buffer``."""
    p = td_errors.abs() + epsilon
    buffer.priorities[indices.to(torch.int64)] = p
    buffer.max_priority = torch.maximum(buffer.max_priority, p.max())
    return buffer


def replay_peek(buffer: ReplayBuffer, back: int = 0) -> dict:
    """The transition ``back`` entries before the newest (Dqn8:109-117)."""
    idx = ((buffer.ptr - 1 - back) % buffer.capacity).to(torch.int64)
    return {
        "board": buffer.boards[idx],
        "action": buffer.actions[idx].to(torch.int64),
        "reward": buffer.rewards[idx],
        "done": buffer.dones[idx],
        "next_board": buffer.next_boards[idx],
    }


def prune_low_score_episodes(buffer: ReplayBuffer,
                             n_to_remove: int) -> ReplayBuffer:
    """Drop the ``n_to_remove`` lowest-scoring complete episodes; returns a
    new buffer.

    Episodes are ``done``-delimited runs in logical (oldest-first) order;
    an episode's score is the sum of its positive rewards; the trailing
    incomplete episode is always kept; order is preserved (Dqn8:119-200).
    Ties in score go to the older episode, as ``jnp.argsort`` (stable)
    ranks them. Scores of simple-reward episodes are sums of integers, so
    the ranking does not depend on the order of the sums.
    """
    c = buffer.capacity
    device = buffer.size.device
    i = torch.arange(c, device=device)
    phys = ((buffer.ptr - buffer.size + i) % c).to(torch.int64)
    valid = i < buffer.size
    rewards = buffer.rewards[phys]
    dones = buffer.dones[phys] & valid

    # Episode id per logical slot: 0-based, increments after each done.
    ends = torch.cumsum(dones.to(torch.int32), 0)
    ep_id = torch.cat([ends.new_zeros(1), ends[:-1]]).to(torch.int64)
    num_complete = ends[-1]

    pos_r = torch.where(valid, torch.clamp_min(rewards, 0.0), 0.0)
    scores = torch.zeros(c, dtype=torch.float32, device=device).index_add_(
        0, ep_id, pos_r)
    is_complete = i < num_complete
    ranked = torch.argsort(torch.where(is_complete, scores, torch.inf),
                           stable=True)
    worst = ranked[:n_to_remove]
    drop_ep = torch.zeros(c, dtype=torch.bool, device=device)
    drop_ep[worst] = worst < num_complete
    keep = valid & ~drop_ep[ep_id]

    # Stable compaction to the front of fresh arrays; dropped slots go to
    # the trash row.
    new_pos = torch.where(keep, torch.cumsum(keep.to(torch.int64), 0) - 1, c)
    new_size = keep.sum(dtype=torch.int32)
    arrays = {}
    for name in ARRAYS:
        src = getattr(buffer, name)
        out = torch.zeros_like(src)
        out[new_pos] = src[phys]
        arrays[name] = out
    # The reference recomputes max_priority from the survivors (Dqn8:200).
    mp = arrays["priorities"][:c].max()
    return ReplayBuffer(
        **arrays,
        max_priority=torch.where(mp > 0, mp, 1.0),
        ptr=new_size % c,
        size=new_size,
    )
