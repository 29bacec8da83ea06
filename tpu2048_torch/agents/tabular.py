"""Tabular Q-learning agent, the port of :mod:`tpu2048.agents.tabular`: the
hashed Q-table's layout, hash and schedule, its ``.npz`` files, and the
legacy two-array table's probe, lookup, update and epsilon-greedy choice.

A board packs into 64 bits (16 cells x 4-bit exponents) held as two 32-bit
words; a key is placed in one 16-slot bucket chosen by a murmur3-style hash,
and unseen states read as zeros (the reference's defaultdict). The default
train loop works on the packed form of the table
(:mod:`tpu2048_torch.agents.tabular_fast`); :class:`QTable` is the
two-array form that files hold and that ``table_backend="legacy"`` trains.

The legacy update keeps the JAX module's scatter semantics as XLA runs them
on the host: of several writes to one key slot the last in batch order
wins, and the TD deltas of one Q row add in batch order onto the stored
row. Here each slot's writers are grouped by a stable sort, so that every
write is deterministic on the card too: the keys' writers of one slot all
write the last one's value, and the deltas are added one rank of the group
at a time, a round for each rank (the number of rounds is read on the host
once an update).

Key words are int32 storage of the raw uint32 patterns: torch has no
unsigned 32-bit arithmetic on the CPU, so the hash widens them to int64 and
masks to 32 bits, and splits each multiplier into 16-bit halves so that no
product leaves the int64 range.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from tpu2048_torch.ops.board import first_true, one_hot

#: Slots per bucket: a key lives in one of the 16 slots of its bucket.
PROBES = 16
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class TabularConfig:
    """Hyperparameters (defaults = Agent/main.py:15)."""

    learning_rate: float = 0.1
    discount: float = 0.9
    exploration_rate: float = 1.0
    exploration_min: float = 0.01
    total_epochs: int = 20000
    capacity_log2: int = 25  # Q-table slots = 2**capacity_log2


@dataclasses.dataclass
class QTable:
    key_lo: torch.Tensor  # (S,) int32: uint32 pattern of cells 0..7
    key_hi: torch.Tensor  # (S,) int32: uint32 pattern of cells 8..15
    q: torch.Tensor  # (S, 4) f32
    dropped: torch.Tensor  # () int32: updates lost to a full bucket

    @property
    def capacity(self) -> int:
        return self.key_lo.shape[0]

    @property
    def occupied(self) -> torch.Tensor:
        """(S,) bool: a slot is occupied iff its key is nonzero (a 2048
        board always has a tile, so no real key is all zero)."""
        return (self.key_lo != 0) | (self.key_hi != 0)


def qtable_init(capacity_log2: int, device="cpu") -> QTable:
    s = 1 << capacity_log2
    return QTable(
        key_lo=torch.zeros(s, dtype=torch.int32, device=device),
        key_hi=torch.zeros(s, dtype=torch.int32, device=device),
        q=torch.zeros((s, 4), dtype=torch.float32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 storage of uint32 patterns -> int64 values in ``[0, 2**32)``."""
    return words.to(torch.int64) & _MASK32


def as_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 storage of the same pattern."""
    return ((values ^ 0x80000000) - 0x80000000).to(torch.int32)


def pack_board(board: torch.Tensor):
    """``(..., 4, 4)`` int8 exponents -> ``(lo, hi)`` int32 words holding the
    uint32 patterns of ``tpu2048.agents.tabular.pack_board``; exponents
    clip at 15."""
    cells = board.reshape(*board.shape[:-2], 16).clamp(0, 15).to(torch.int64)
    shifts = torch.arange(8, device=board.device, dtype=torch.int64) * 4
    lo = (cells[..., :8] << shifts).sum(-1)
    hi = (cells[..., 8:] << shifts).sum(-1)
    return as_int32(lo), as_int32(hi)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2**32`` for int64 ``a`` in ``[0, 2**32)``: each product
    with a 16-bit half of ``m`` stays below ``2**48``."""
    lo_part = a * (m & 0xFFFF)
    hi_part = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo_part + hi_part) & _MASK32


def _hash(lo: torch.Tensor, hi: torch.Tensor, capacity: int) -> torch.Tensor:
    """Murmur3-style finalizer over the two words -> int32 index in
    ``[0, capacity)`` (``tpu2048.agents.tabular._hash``)."""
    h = unsigned(lo) ^ _mul32(unsigned(hi), 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & (capacity - 1)).to(torch.int32)


def _probe(table: QTable, lo: torch.Tensor, hi: torch.Tensor):
    """For each key, ``(match_slot, free_slot)``: int32 slots, -1 when not
    found in the key's 16-slot bucket (``tpu2048.agents.tabular._probe``).
    An all-zero key matches and claims nothing."""
    n_buckets = table.capacity // PROBES
    bucket = _hash(lo, hi, n_buckets).to(torch.int64)
    slots = bucket[:, None] * PROBES + torch.arange(PROBES,
                                                    device=lo.device)
    wlo = table.key_lo.view(n_buckets, PROBES)[bucket]
    whi = table.key_hi.view(n_buckets, PROBES)[bucket]
    real = ((lo | hi) != 0)[:, None]
    match = (wlo == lo[:, None]) & (whi == hi[:, None]) & real
    free = (wlo == 0) & (whi == 0) & real

    def first(mask):
        slot = slots.gather(1, first_true(mask)[:, None])[:, 0]
        return torch.where(mask.any(1), slot, -1).to(torch.int32)

    return first(match), first(free)


def _read_rows(table: QTable, match_slot: torch.Tensor) -> torch.Tensor:
    """``(B, 4)`` Q rows of the matched slots, zeros where none matched."""
    q = table.q[match_slot.clamp_min(0).to(torch.int64)]
    return torch.where((match_slot >= 0)[:, None], q, 0.0)


def qtable_lookup(table: QTable, boards: torch.Tensor) -> torch.Tensor:
    """Batched read: ``(B, 4)`` float32 Q, zeros for unseen states."""
    lo, hi = pack_board(boards)
    return _read_rows(table, _probe(table, lo, hi)[0])


def _groups(slots: torch.Tensor):
    """Group a batch's writes by slot, batch order kept within a group.

    Returns ``(order, start, size)``: the stable sort of ``slots`` (int64),
    and for each sorted position its group's first sorted position and its
    group's size.
    """
    order = torch.argsort(slots, stable=True)
    s = slots[order]
    n = s.numel()
    idx = torch.arange(n, device=s.device)
    lead = torch.ones(n, dtype=torch.bool, device=s.device)
    lead[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(lead, idx, 0), 0).values
    group = lead.cumsum(0) - 1
    counts = torch.zeros(n, dtype=torch.int64, device=s.device).index_add_(
        0, group, torch.ones_like(group))
    return order, start, counts[group]


def _set_last_(dest: torch.Tensor, slots: torch.Tensor,
               values: torch.Tensor) -> None:
    """``dest[slots[i]] = values[i]`` in place, the last write of a slot in
    batch order winning (XLA's scatter on the host)."""
    order, start, size = _groups(slots)
    last = values[order][start + size - 1]
    dest[slots[order]] = last


def _add_rows_(q: torch.Tensor, slots: torch.Tensor, delta: torch.Tensor,
               keep: torch.Tensor) -> None:
    """``q[slots[i]] += delta[i]`` in place for the entries with ``keep``,
    the rows of one slot added in batch order onto the stored row (XLA's
    scatter-add on the host). The other entries add nothing: their rows
    are zeros, and a zero added to a Q value that started at +0.0 leaves it
    as it is."""
    n_slots = q.shape[0]
    order, start, size = _groups(torch.where(keep, slots, n_slots))
    s, d = slots[order], delta[order]
    kept = keep[order]  # first in the sort
    rounds = int(torch.where(kept, size, 0).max()) if s.numel() else 0
    if rounds == 0:
        return
    # The dropped entries read and write the first kept entry's slot, and
    # every writer of a slot writes the same row: no write races.
    s = torch.where(kept, s, s[0])
    acc = q[s]
    for rank in range(rounds):
        has = (kept & (rank < size))[:, None]
        acc = torch.where(has, acc + d[(start + rank).clamp_max(len(s) - 1)],
                          acc)
    q[s] = torch.where(kept[:, None], acc, acc[0])


def qtable_update(table: QTable, boards, actions, targets,
                  learning_rate: float, probe=None) -> QTable:
    """Batched Q-update toward ``targets`` (``tpu2048.agents.tabular.
    qtable_update``), in place: returns the table with its new ``dropped``.

    Unseen states claim a free slot of their bucket; when fresh keys race
    for one slot the last in batch order keeps it, and the losers, like
    entries whose bucket is full, drop and count in ``dropped``. Every TD
    uses the pre-update Q, and updates of one slot add. ``probe`` is
    ``(lo, hi, match_slot, free_slot)`` from :func:`choose_actions_probed`
    on the same table and boards.
    """
    if probe is not None:
        lo, hi, match_slot, free_slot = probe
    else:
        lo, hi = pack_board(boards)
        match_slot, free_slot = _probe(table, lo, hi)
    slot = torch.where(match_slot >= 0, match_slot, free_slot)
    valid = slot >= 0
    safe = slot.clamp_min(0).to(torch.int64)
    is_new = (match_slot < 0) & valid
    claim = torch.where(is_new, safe, 0)
    q_rows = table.q[safe]
    for words, key in ((table.key_lo, lo), (table.key_hi, hi)):
        _set_last_(words, claim, torch.where(is_new, key, words[claim]))
    won = (table.key_lo[safe] == lo) & (table.key_hi[safe] == hi)
    valid = valid & won
    onehot = one_hot(actions, 4)
    q_sa = (q_rows * onehot).sum(1)
    q_sa = torch.where(is_new & valid, 0.0, q_sa)  # fresh rows read zero
    td = torch.where(valid, learning_rate * (targets - q_sa), 0.0)
    _add_rows_(table.q, safe, td[:, None] * onehot, valid)
    return QTable(key_lo=table.key_lo, key_hi=table.key_hi, q=table.q,
                  dropped=table.dropped + (~valid).sum(dtype=torch.int32))


def q_learning_targets(table: QTable, rewards, next_boards, dones,
                       discount: float) -> torch.Tensor:
    """``r + gamma * max_a' Q[s'] * (1 - done)`` (Agent/main.py:40-43)."""
    best = qtable_lookup(table, next_boards).amax(-1)
    return rewards + discount * best * (1.0 - dones.to(torch.float32))


def choose_actions_probed(table: QTable, boards, epsilon, draws):
    """Batched epsilon-greedy (Agent/main.py:34-38), with the probe that
    :func:`qtable_update` reuses.

    ``epsilon`` is a float32 scalar tensor; ``draws`` is a draw source
    ``b -> (explore_uniform, random_action)``, as the packed path takes.
    The greedy branch is the first argmax of the Q row (zeros -> action 0).
    """
    explore_u, random_actions = draws(boards.shape[0])
    lo, hi = pack_board(boards)
    match_slot, free_slot = _probe(table, lo, hi)
    greedy = _read_rows(table, match_slot).argmax(-1).to(torch.int32)
    actions = torch.where(explore_u < epsilon, random_actions, greedy)
    return actions, (lo, hi, match_slot, free_slot)


def choose_actions(table: QTable, boards, epsilon, draws) -> torch.Tensor:
    """Batched epsilon-greedy (Agent/main.py:34-38)."""
    return choose_actions_probed(table, boards, epsilon, draws)[0]


def epsilon_for_epoch(epoch: torch.Tensor, config: TabularConfig):
    """Closed form of the reference's 4-phase decay (Agent/main.py:23-32,
    45-57): phases at 30% / 60% / 80% of ``total_epochs``. ``epoch`` is a
    float32 tensor of completed epochs; the result is float32, computed in
    the JAX package's order with its float32 constants."""
    t = float(config.total_epochs)
    e0 = config.exploration_rate
    emin = config.exploration_min
    b1, b2, b3 = 0.30 * t, 0.60 * t, 0.80 * t
    slow1 = (e0 - emin * 1.5) / b1
    fast = ((e0 - emin) - emin * 1.5) / (b2 - b1)
    slow2 = (emin * 1.1 - emin) / (b3 - b2)
    n1, n2, n3 = math.ceil(b1), math.ceil(b2), math.ceil(b3)
    # Python floats meet float32 tensors as float32 values, as JAX's weak
    # scalars do; no constant is copied to the device.
    epoch = epoch.to(torch.float32)
    k1 = epoch.clamp(0.0, n1)
    k2 = (epoch - n1).clamp(0.0, n2 - n1)
    k3 = (epoch - n2).clamp(0.0, n3 - n2)
    eps = (e0 - slow1 * k1).clamp_min(emin * 1.5)
    eps = torch.where(k2 > 0, (eps - fast * k2).clamp_min(emin * 1.1), eps)
    eps = torch.where(k3 > 0, (eps - slow2 * k3).clamp_min(emin), eps)
    return torch.where(epoch > n3, emin, eps)


def save_qtable(path: str, table: QTable) -> None:
    """Write the table as one compressed ``.npz`` that the JAX package's
    ``load_qtable`` reads: keys as uint32 (the JAX loader hashes them in the
    dtype it finds), ``occupied``, ``q``, ``dropped`` and
    ``layout="bucketed"``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        key_lo=table.key_lo.cpu().numpy().view(np.uint32),
        key_hi=table.key_hi.cpu().numpy().view(np.uint32),
        occupied=table.occupied.cpu().numpy(),
        q=table.q.cpu().numpy(),
        dropped=table.dropped.cpu().numpy(),
        layout=np.asarray("bucketed"),
    )


def rehash_table(table: QTable) -> QTable:
    """Re-place every occupied entry under the bucketed hash
    (``tpu2048.agents.tabular.rehash_table``): entries are sorted by their
    bucket, ranked within it and written to ``bucket * PROBES + rank``;
    entries past a full bucket drop and count in ``dropped``."""
    s = table.capacity
    n_buckets = s // PROBES
    device = table.key_lo.device
    occ = table.occupied
    bucket = _hash(table.key_lo, table.key_hi, n_buckets)
    order = torch.argsort(torch.where(occ, bucket, n_buckets), stable=True)
    sb = bucket[order].to(torch.int64)
    so = occ[order]
    idx = torch.arange(s, device=device)
    run_start = torch.ones(s, dtype=torch.bool, device=device)
    run_start[1:] = sb[1:] != sb[:-1]
    start_idx = torch.cummax(torch.where(run_start, idx, 0), 0).values
    rank = idx - start_idx
    valid = so & (rank < PROBES)
    dest = torch.where(valid, sb * PROBES + rank, s)  # s: dropped

    def place(values):
        out = torch.zeros((s + 1, *values.shape[1:]), dtype=values.dtype,
                          device=device)
        out[dest] = values[order]
        return out[:s]

    return QTable(
        key_lo=place(table.key_lo),
        key_hi=place(table.key_hi),
        q=place(table.q),
        dropped=table.dropped + (so & ~valid).sum(dtype=torch.int32),
    )


def load_qtable(path: str, device="cpu") -> QTable:
    """Read a ``.npz`` written by :func:`save_qtable` or the JAX package;
    keys may be uint32 or int32. A file without ``layout="bucketed"`` (the
    linear-probe layout of older runs) is re-placed by :func:`rehash_table`.
    """
    with np.load(path) as z:
        def words(name):
            return torch.from_numpy(
                np.ascontiguousarray(z[name]).view(np.int32).copy())

        table = QTable(
            key_lo=words("key_lo"),
            key_hi=words("key_hi"),
            q=torch.from_numpy(np.asarray(z["q"], np.float32).copy()),
            dropped=torch.tensor(int(z["dropped"]), dtype=torch.int32),
        )
        layout = str(z["layout"]) if "layout" in z else "linear"
    table = QTable(**{f.name: getattr(table, f.name).to(device)
                      for f in dataclasses.fields(QTable)})
    if layout != "bucketed":
        table = rehash_table(table)
    return table
