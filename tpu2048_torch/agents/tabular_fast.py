"""Packed Q-table fast path, the port of :mod:`tpu2048.agents.tabular_fast`:
the tabular hot loop on the bucket gather and scatter kernels.

The table is one ``(n_buckets + 1, 128)`` int32 tensor in the layout of
:mod:`tpu2048_torch.ops.table_kernel`; its last row is the write-only trash
row. A train step moves the big table's bytes in exactly three kernel
launches: gather of the s-buckets, gather of the s'-buckets, and scatter of
the merged bucket images, which writes into the table in place. The probe,
claim and TD logic runs on the small gathered ``(B, 16, 8)`` images in
plain PyTorch.

Semantics (as the JAX module's): same hash, bucketed probe and
defaultdict-zeros reads; every entry's TD uses the pre-update Q, and
duplicate updates of one (state, action) in a batch add; a claim race
between different fresh keys for one free slot goes to the lowest batch
index, and the losers drop and count in ``dropped``, as do entries whose
bucket is full.

The agent's randomness is explicit: a draw source ``b -> (explore_uniform
(B,) f32, random_action (B,) int32)`` replaces the JAX key.
:class:`GeneratorDraws` draws from a ``torch.Generator`` on the device;
:class:`ReplayDraws` replays given draws (the tests feed it JAX's).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import torch

from tpu2048_torch.agents import tabular as tab
from tpu2048_torch.ops import table_kernel as tk

if tk.BUCKET != tab.PROBES:
    raise ImportError("the table kernel's bucket width must equal PROBES")

_BIG = 0x7FFFFFFF


@dataclasses.dataclass
class PackedQTable:
    data: torch.Tensor  # (n_buckets + 1, 128) int32; last row = trash
    dropped: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return (self.data.shape[0] - 1) * tk.BUCKET

    @property
    def occupied(self) -> torch.Tensor:
        """(S,) bool in slot order, by the key-sentinel rule of
        :attr:`tpu2048_torch.agents.tabular.QTable.occupied`."""
        d = self.data[:-1]
        return ((d[:, 0::tk.WIDTH] != 0) | (d[:, 1::tk.WIDTH] != 0)).reshape(-1)


def pack_qtable(table: tab.QTable) -> PackedQTable:
    """Two-array table -> packed layout (once, at load)."""
    nb = table.capacity // tk.BUCKET
    data = torch.zeros((nb + 1, tk.ROW), dtype=torch.int32,
                       device=table.key_lo.device)
    body = data[:-1]
    body[:, 0::tk.WIDTH] = table.key_lo.view(nb, tk.BUCKET)
    body[:, 1::tk.WIDTH] = table.key_hi.view(nb, tk.BUCKET)
    qbits = table.q.view(torch.int32)
    for j in range(4):
        body[:, 2 + j::tk.WIDTH] = qbits[:, j].reshape(nb, tk.BUCKET)
    return PackedQTable(data=data, dropped=table.dropped.clone())


def unpack_qtable(packed: PackedQTable) -> tab.QTable:
    """Packed -> two-array table (to save, or to compare)."""
    d = packed.data[:-1]
    q = torch.stack([d[:, 2 + j::tk.WIDTH].reshape(-1) for j in range(4)],
                    dim=1).view(torch.float32)
    return tab.QTable(
        key_lo=d[:, 0::tk.WIDTH].reshape(-1),
        key_hi=d[:, 1::tk.WIDTH].reshape(-1),
        q=q,
        dropped=packed.dropped.clone(),
    )


def packed_init(capacity_log2: int, device="cpu") -> PackedQTable:
    nb = (1 << capacity_log2) // tk.BUCKET
    return PackedQTable(
        data=torch.zeros((nb + 1, tk.ROW), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


class GeneratorDraws:
    """Draw source for production: ``torch.rand`` and ``torch.randint``
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        explore_u = torch.rand(batch, generator=self.generator,
                               device=self.device)
        random_action = torch.randint(0, 4, (batch,), dtype=torch.int32,
                                      generator=self.generator,
                                      device=self.device)
        return explore_u, random_action


class ReplayDraws:
    """Draw source that returns the given ``(explore_u, random_action)``
    pairs in order."""

    def __init__(self, draws: Iterable[Tuple[torch.Tensor, torch.Tensor]]):
        self._draws = iter(draws)

    def __call__(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        explore_u, random_action = next(self._draws)
        if (explore_u.shape != (batch,) or explore_u.dtype != torch.float32
                or random_action.shape != (batch,)
                or random_action.dtype != torch.int32):
            raise ValueError(
                f"replayed draws are {tuple(explore_u.shape)} "
                f"{explore_u.dtype} / {tuple(random_action.shape)} "
                f"{random_action.dtype}, expected ({batch},) float32 / "
                f"({batch},) int32")
        return explore_u, random_action


def one_hot(x: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``(..., n)`` one-hot of int ``x`` (all zero outside ``[0, n)``)."""
    return (x.unsqueeze(-1) == torch.arange(n, device=x.device)).to(dtype)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 where none), int64."""
    return mask.to(torch.int8).argmax(1)


def _probe_gathered(g, lo, hi):
    """Probe the gathered buckets ``(B, 16, 8)``.

    Returns ``(match_idx, free_idx, q_rows)``: int32 slot-in-bucket indices,
    -1 when absent, and the matched slot's float32 Q-row (zeros for an
    unseen state, the reference's defaultdict).
    """
    wlo, whi = g[:, :, 0], g[:, :, 1]
    real = ((lo | hi) != 0).unsqueeze(1)
    match = (wlo == lo.unsqueeze(1)) & (whi == hi.unsqueeze(1)) & real
    free = (wlo == 0) & (whi == 0) & real
    first_match = _first_true(match)
    has_match = match.any(1)
    first_free = _first_true(free)
    has_free = free.any(1)
    q_rows = g[:, :, 2:6].gather(
        1, first_match.view(-1, 1, 1).expand(-1, 1, 4))[:, 0]
    q_rows = torch.where(has_match.unsqueeze(1), q_rows.view(torch.float32),
                         0.0)
    match_idx = torch.where(has_match, first_match, -1).to(torch.int32)
    free_idx = torch.where(has_free, first_free, -1).to(torch.int32)
    return match_idx, free_idx, q_rows


def _bucket_of(packed: PackedQTable, boards):
    lo, hi = tab.pack_board(boards)
    return lo, hi, tab._hash(lo, hi, packed.capacity // tab.PROBES)


def fast_choose_actions_probed(packed: PackedQTable, boards, epsilon, draws):
    """Batched epsilon-greedy (Agent/main.py:34-38) on one gather.

    ``epsilon`` is a float32 scalar tensor; ``draws`` the draw source.
    Returns ``(actions, probe)``; ``probe`` carries the gathered bucket
    images and the probe results that :func:`fast_update` reuses.
    """
    explore_u, random_actions = draws(boards.shape[0])
    explore = explore_u < epsilon
    lo, hi, bucket = _bucket_of(packed, boards)
    g = tk.bucket_gather(packed.data, bucket)
    match_idx, free_idx, q_rows = _probe_gathered(g, lo, hi)
    greedy = q_rows.argmax(-1).to(torch.int32)
    actions = torch.where(explore, random_actions, greedy)
    return actions, (lo, hi, bucket, g, match_idx, free_idx, q_rows)


def fast_targets(packed: PackedQTable, rewards, next_boards, dones,
                 discount: float):
    """``r + gamma * max_a' Q[s'] * (1 - done)`` (Agent/main.py:40-43) on one
    gather."""
    lo, hi, bucket = _bucket_of(packed, next_boards)
    g = tk.bucket_gather(packed.data, bucket)
    _, _, q_rows = _probe_gathered(g, lo, hi)
    best = q_rows.amax(-1)
    return rewards + discount * best * (1.0 - dones.to(torch.float32))


def _segment_ids(sorted_keys: torch.Tensor):
    """Lead flags and segment ids of a sorted key vector."""
    is_lead = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_lead[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return is_lead, is_lead.to(torch.int64).cumsum(0) - 1


def resolve_updates(probe, actions, targets, learning_rate: float,
                    trash: int):
    """Claims and merges: probe and TD -> distinct bucket images
    (``tpu2048.agents.tabular_fast.resolve_updates``).

    Entries of one bucket form a group (stable sort: batch order inside);
    the group writes ONE image, its gathered base with every kept member's
    contribution: Q deltas add per (slot, action) in batch order, as
    ``((0 + d0) + d1) + d2`` then ``base + sum``; a claimed slot takes the
    claimant's key. Fresh claims keep only entries sharing the key of the
    group's lowest-index claimant; entries with no slot drop.

    Returns ``(bucket_ids, rows, n_dropped)``: ``(B,)`` int32 ids in ``[0,
    trash]``, distinct below ``trash``; ``(B, 16, 8)`` int32 images; ``()``
    int32.
    """
    lo, hi, bucket, g, match_idx, free_idx, q_rows = probe
    b = lo.shape[0]
    device = lo.device
    idx = torch.where(match_idx >= 0, match_idx, free_idx)
    valid = idx >= 0
    is_new = (match_idx < 0) & valid

    onehot = one_hot(actions, 4)
    q_sa = (q_rows * onehot).sum(1)
    td_rows = (learning_rate * (targets - q_sa)).unsqueeze(1) * onehot

    sort_key = torch.where(valid, bucket, _BIG)
    order = torch.argsort(sort_key, stable=True)
    s_bucket = sort_key[order]
    s_valid = valid[order]
    s_new = is_new[order]
    s_idx = idx[order].clamp_min(0).long()
    s_lo, s_hi = lo[order], hi[order]
    pos = torch.arange(b, device=device)
    is_lead, group = _segment_ids(s_bucket)

    # All of a group's fresh entries target its first free slot, so the
    # claim goes to the group's lowest-index fresh entry; kept claimants
    # share its key.
    claim_pos = torch.full((b,), _BIG, dtype=torch.int64, device=device)
    claim_pos.scatter_reduce_(0, group, torch.where(s_new, pos, _BIG), "amin")
    cp = claim_pos[group].clamp(0, b - 1)
    key_ok = (s_lo == s_lo[cp]) & (s_hi == s_hi[cp])
    keep = s_valid & (~s_new | key_ok)
    n_dropped = (~keep).sum(dtype=torch.int32)

    # Per-entry Q deltas, summed per group in batch order from zero: a
    # sequential fold per segment (torch.segment_reduce), never float
    # atomics, whose order changes from run to run.
    slot_oh = one_hot(s_idx, tk.BUCKET)
    q_delta = (slot_oh.unsqueeze(2) * td_rows[order].unsqueeze(1)
               * keep.to(torch.float32).view(-1, 1, 1))
    lengths = torch.zeros(b, dtype=torch.int64, device=device)
    lengths.scatter_add_(0, group, torch.ones_like(group))
    q_sum = torch.segment_reduce(q_delta, "sum", lengths=lengths,
                                 unsafe=True, initial=0.0)

    # A group claims at most one slot, with its winner's key; the claimed
    # slot was free (key 0), every other slot keeps its base key.
    has_claim = (claim_pos[group] < _BIG).unsqueeze(1)
    claimed = has_claim & (torch.arange(tk.BUCKET, device=device)
                           == s_idx[cp].unsqueeze(1))
    base = g[order]
    new_klo = torch.where(claimed, s_lo[cp].unsqueeze(1), base[:, :, 0])
    new_khi = torch.where(claimed, s_hi[cp].unsqueeze(1), base[:, :, 1])
    new_q = base[:, :, 2:6].view(torch.float32) + q_sum[group]
    rows = torch.cat([
        new_klo.unsqueeze(2),
        new_khi.unsqueeze(2),
        new_q.view(torch.int32),
        torch.zeros((b, tk.BUCKET, 2), dtype=torch.int32, device=device),
    ], dim=2)
    write = is_lead & s_valid
    bucket_ids = torch.where(write, s_bucket, trash).to(torch.int32)
    return bucket_ids, rows, n_dropped


def fast_update(packed: PackedQTable, probe, actions, targets,
                learning_rate: float) -> PackedQTable:
    """Batched Q-update (Agent/main.py:40-43) on one scatter, which writes
    into ``packed.data`` in place; returns the table with the new
    ``dropped``. ``probe`` comes from :func:`fast_choose_actions_probed` on
    the same table and boards."""
    bucket_ids, rows, n_dropped = resolve_updates(
        probe, actions, targets, learning_rate,
        trash=packed.data.shape[0] - 1,
    )
    tk.bucket_scatter_(packed.data, bucket_ids, rows)
    return PackedQTable(data=packed.data, dropped=packed.dropped + n_dropped)


def fast_lookup(packed: PackedQTable, boards) -> torch.Tensor:
    """Batched read on one gather: ``(B, 4)`` float32 Q, zeros for unseen
    states."""
    lo, hi, bucket = _bucket_of(packed, boards)
    g = tk.bucket_gather(packed.data, bucket)
    return _probe_gathered(g, lo, hi)[2]
