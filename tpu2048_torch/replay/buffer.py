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

Insertion, sampling and the priority update also take a sharded buffer
(:mod:`tpu2048_torch.replay.sharded`): the same arrays with a leading shard
axis, ``(S, C/S + 1, ...)`` and ``(S,)`` scalars. They then do the flat
operation in each shard, as one indexing of every shard at once;
a flat buffer is the one-shard case without the axis. The JAX module's
``ReplayConfig``, which nothing reads, is not ported: the DQN's replay
settings are fields of ``DQNConfig``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ReplayBuffer:
    # Flat shapes; a sharded buffer has a leading (S,) axis on each.
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
        """Slots (of each shard, when sharded)."""
        return self.boards.shape[-3] - 1


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


def _at(buffer: ReplayBuffer, slots: torch.Tensor):
    """The index of ``slots`` (int64; ``(S, n)`` within their shards, or
    ``(n,)`` of a flat buffer) into the per-slot arrays."""
    if not buffer.ptr.dim():
        return slots
    return torch.arange(slots.shape[0], device=slots.device)[:, None], slots


def _take(buffer: ReplayBuffer, x: torch.Tensor, at) -> torch.Tensor:
    """``x`` at index ``at``, flat in shard order."""
    return x[at].flatten(0, 1) if buffer.ptr.dim() else x[at]


def _per_shard(buffer: ReplayBuffer, x: torch.Tensor) -> torch.Tensor:
    """``(B, ...)`` as ``(S, B/S, ...)`` (as it is, for a flat buffer);
    raises when B does not divide."""
    if not buffer.ptr.dim():
        return x
    s = buffer.ptr.shape[0]
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} entries not divisible by {s} shards")
    return x.reshape(s, x.shape[0] // s, *x.shape[1:])


def replay_add(buffer: ReplayBuffer, boards, actions, rewards, dones,
               next_boards, mask) -> ReplayBuffer:
    """Insert the transitions whose ``mask`` is True, compacted, in place.

    Masked-out entries (the actor's dedup skips, Dqn8:283-297) consume no
    slots. New entries get ``max_priority`` (Dqn8:44-46). Ring semantics:
    the oldest entries are overwritten once full. Sharded, env i goes to
    shard ``i // (B/S)``, each shard with its own ring and ``max_priority``.
    Returns ``buffer``.
    """
    c = buffer.capacity
    mask = _per_shard(buffer, mask)
    m = mask.to(torch.int32)
    offsets = torch.cumsum(m, -1, dtype=torch.int32) - 1
    n_added = m.sum(-1, dtype=torch.int32)
    pos = torch.where(mask, (buffer.ptr[..., None] + offsets) % c, c)
    at = _at(buffer, pos.to(torch.int64))
    buffer.boards[at] = _per_shard(buffer, boards.to(torch.int8))
    buffer.next_boards[at] = _per_shard(buffer, next_boards.to(torch.int8))
    buffer.actions[at] = _per_shard(buffer, actions.to(torch.int8))
    buffer.rewards[at] = _per_shard(buffer, rewards.to(torch.float32))
    buffer.dones[at] = _per_shard(buffer, dones)
    buffer.priorities[at] = buffer.max_priority[..., None]
    buffer.ptr = (buffer.ptr + n_added) % c
    buffer.size = torch.clamp_max(buffer.size + n_added, c)
    return buffer


def _probabilities(buffer: ReplayBuffer, alpha: float) -> torch.Tensor:
    """Per-slot sampling probabilities (Dqn8:75-83), ``(C,)`` f32 (``(S,
    C/S)`` sharded, each shard's summing to 1)."""
    c = buffer.capacity
    in_range = (torch.arange(c, device=buffer.size.device)
                < buffer.size[..., None]).to(torch.float32)
    if alpha == 0.0:
        p = in_range
    else:
        p = torch.where(in_range > 0, buffer.priorities[..., :c] ** alpha,
                        0.0)
        # The reference falls back to uniform when all priorities are 0.
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, in_range)
    return p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)


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
    reference. The batch's ``action`` is int64. Sharded, ``batch/S`` a
    shard: ``indices`` are ``(S, batch/S)`` slots within their shards (or
    that many in shard order), returned so; the batch and the weights are
    flat in shard order, each shard's weights normalized by their own max.
    """
    indices = _per_shard(buffer, indices.to(torch.int64).reshape(-1))
    if alpha == 0.0:
        w = torch.ones((batch_size,), dtype=torch.float32,
                       device=indices.device)
    else:
        p = _probabilities(buffer, alpha)
        n = torch.clamp_min(buffer.size.to(torch.float32), 1.0)[..., None]
        w = (n * p.gather(-1, indices)) ** (-beta)
        w = (w / torch.clamp_min(w.amax(-1, keepdim=True), 1e-30)
             ).reshape(-1)
    at = _at(buffer, indices)
    batch = {
        "board": _take(buffer, buffer.boards, at),
        "action": _take(buffer, buffer.actions, at).to(torch.int64),
        "reward": _take(buffer, buffer.rewards, at),
        "done": _take(buffer, buffer.dones, at),
        "next_board": _take(buffer, buffer.next_boards, at),
    }
    return batch, indices, w


def replay_update_priorities(buffer: ReplayBuffer, indices, td_errors,
                             epsilon: float = 1e-6) -> ReplayBuffer:
    """``priority[i] = |td| + eps``; bump ``max_priority`` (Dqn8:97-104).
    Sharded, ``indices`` are :func:`replay_sample`'s ``(S, batch/S)`` and
    each shard's ``max_priority`` is bumped by its own. In place; returns
    ``buffer``."""
    p = td_errors.abs() + epsilon
    indices = _per_shard(buffer, indices.to(torch.int64).reshape(-1))
    p = _per_shard(buffer, p)
    buffer.priorities[_at(buffer, indices)] = p
    buffer.max_priority = torch.maximum(buffer.max_priority, p.amax(-1))
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
