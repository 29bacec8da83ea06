"""Sharded replay memory: S independent shards of one buffer, the port of
:mod:`tpu2048.replay.sharded`.

Transitions never cross shards. A sharded buffer is
:class:`tpu2048_torch.replay.buffer.ReplayBuffer` with a leading shard axis:
each per-slot array is ``(S, C/S + 1, ...)`` (every shard with its own trash
row) and ``max_priority``, ``ptr`` and ``size`` are ``(S,)``. The B envs of
a vector step insert env i into shard ``i // (B/S)``; sampling draws
``batch/S`` a shard with importance weights normalised per shard; priority
updates and the prune stay inside their shard. Insertion, sampling and the
priority update are :mod:`tpu2048_torch.replay.buffer`'s operations, which
take the shard axis and index every shard at once; the prune (rare) is the
flat prune in a loop over the shards, as the JAX module ``vmap``s the flat
operations.

A flat buffer is the one-shard case: :func:`sharded_init` with
``shards=1`` returns it, so that a one-shard training state and its
checkpoints keep the flat layout, and every operation here takes it.
Operations update the buffer in place and return it, but for the prune,
which returns a new buffer.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu2048_torch.replay import buffer as flat

# Re-export: a sharded buffer is the same dataclass with a leading axis.
ReplayBuffer = flat.ReplayBuffer
FIELDS = tuple(f.name for f in dataclasses.fields(ReplayBuffer))


def num_shards(buffer: ReplayBuffer) -> int:
    return 1 if buffer.ptr.dim() == 0 else buffer.ptr.shape[0]


def shard(buffer: ReplayBuffer, s: int) -> ReplayBuffer:
    """Shard ``s`` as a flat buffer of views."""
    if not buffer.ptr.dim():
        if s != 0:
            raise IndexError(f"shard {s} of a flat buffer")
        return buffer
    return ReplayBuffer(**{f: getattr(buffer, f)[s] for f in FIELDS})


def sharded_init(capacity: int, shards: int, device="cpu") -> ReplayBuffer:
    """``(S, C/S + 1, ...)`` buffer; ``capacity`` is the global capacity.
    With one shard, the flat buffer."""
    if capacity % shards:
        raise ValueError(f"capacity {capacity} not divisible by {shards}")
    per = flat.replay_init(capacity // shards, device)
    if shards == 1:
        return per
    return ReplayBuffer(**{
        f: getattr(per, f).unsqueeze(0).repeat(
            shards, *([1] * getattr(per, f).dim()))
        for f in FIELDS})


# Insertion, sampling and the priority update are the flat buffer's own
# operations, which take the leading shard axis (env i -> shard i // (B/S),
# ``batch/S`` samples a shard at ``(S, batch/S)`` indices, weights and
# ``max_priority`` per shard).
sharded_add = flat.replay_add
sharded_sample = flat.replay_sample
sharded_update_priorities = flat.replay_update_priorities


def sharded_prune(buffer: ReplayBuffer, n_to_remove: int) -> ReplayBuffer:
    """Prune the ``n_to_remove`` worst episodes *per shard* (global n x S),
    as :func:`tpu2048_torch.replay.buffer.prune_low_score_episodes` does;
    returns a new buffer. The reference prunes the global 10 worst
    (mainDQL:318-320); per shard keeps the operation inside its shard, a
    documented multi-device delta of the JAX package."""
    if not buffer.ptr.dim():
        return flat.prune_low_score_episodes(buffer, n_to_remove)
    pruned = [flat.prune_low_score_episodes(shard(buffer, i), n_to_remove)
              for i in range(num_shards(buffer))]
    return ReplayBuffer(**{f: torch.stack([getattr(p, f) for p in pruned])
                           for f in FIELDS})


def shard_sizes(buffer: ReplayBuffer) -> torch.Tensor:
    """``(S,)`` int32 valid entries of each shard (``()`` of a flat
    buffer)."""
    return buffer.size


def total_size(buffer: ReplayBuffer) -> torch.Tensor:
    return buffer.size.sum()
