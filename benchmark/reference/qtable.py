"""The reference of ``tabular_qtable_ref``: the hashed Q-table learner of
Rocco9999/2048_Q-Learning's ``QLearningBase`` on its shaped env
(``Game2048_env.py``), batched over lanes, in plain NumPy and PyTorch.

The table maps a board's 64-bit key (16 cells of 4 bits, cell 0 lowest) to
four float32 Q-values, zeros for a board never stored. A key lives in one
bucket of ``bucket_slots`` slots, chosen by the configuration's hash of the
key's two 32-bit words; slots fill in order and are never freed. A batch
step reads every Q-value before it writes any. Its updates add, per bucket
in lane order: each kept lane adds ``lr * (target - Q[s, a])`` to its
slot's action, the sums start from zero and are added to the stored row
once. A key not in its bucket claims the first free slot; of several lanes
with new keys in one bucket, the lowest lane claims it, lanes with the same
key share it, lanes with another new key and lanes whose bucket is full are
dropped and counted. A run starts from a filled table (:func:`fill`), which
the benchmark makes and hands to the program and to the reference alike.

``quant="bf16"`` stores every Q-value rounded to bfloat16 (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import game

M32 = 0xFFFFFFFF


def pack(board: torch.Tensor):
    """``(lo, hi)`` 32-bit words of ``(B, 16)`` boards, as int64 tensors."""
    cells = board.clamp(0, 15).to(torch.int64)
    shifts = torch.arange(8, device=board.device) * 4
    return ((cells[:, :8] << shifts).sum(1), (cells[:, 8:] << shifts).sum(1))


def keys(lo, hi):
    """The 64-bit keys, as Python ints."""
    return [h << 32 | lo_ for lo_, h in zip(lo.tolist(), hi.tolist())]


def bucket_of(lo, hi, n_buckets: int) -> torch.Tensor:
    """The configuration's hash of int64 tensors of the words: a
    murmur3-style finalizer over ``lo ^ (hi * 0x9E3779B1)``, all mod
    2**32, masked to the bucket count (a power of two)."""
    h = lo ^ ((hi * 0x9E3779B1) & M32)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h & (n_buckets - 1)


def fill(cfg, spec, seed: int, device):
    """The table a run starts from, in the configuration's layout: the
    boards that random legal play reaches from fresh games (``spec``:
    ``lanes`` games for ``steps`` moves, restarting at game over), ``keys``
    of them drawn from the distinct ones, each with four Q-values from a
    unit normal, placed in its bucket's slots in the draw's order; those a
    full bucket has no slot for are left out. Returns the ``(n_buckets,
    128)`` int32 rows and the count of stored keys."""
    slots = cfg["bucket_slots"]
    nb = (1 << cfg["capacity_log2"]) // slots
    g = torch.Generator(device=device).manual_seed(seed)
    lanes = spec["lanes"]

    def words():
        return torch.randint(-2**31, 2**31, (8, lanes), generator=g,
                             device=device)

    board = game.word_fresh(*words()[4:8])
    seen = []
    for _ in range(spec["steps"]):
        legal = game.legal(board)
        n = legal.sum(1)
        pick = (torch.rand(lanes, generator=g, device=device) * n).long()
        nth = (legal.cumsum(1) == pick[:, None] + 1) & legal
        out = game.word_step(board, nth.to(torch.int8).argmax(1), words())
        lo, hi = pack(out["new"])
        seen.append(hi << 32 | lo)
        board = out["final"]
    k = torch.unique(torch.cat(seen))
    k = k[torch.randperm(len(k), generator=g, device=device)[:spec["keys"]]]
    lo, hi = k & M32, (k >> 32) & M32
    bucket = bucket_of(lo, hi, nb)
    order = torch.sort(bucket, stable=True).indices
    bucket, lo, hi = bucket[order], lo[order], hi[order]
    first = torch.searchsorted(bucket, bucket)
    slot = torch.arange(len(bucket), device=device) - first
    keep = slot < slots
    q = torch.randn((len(k), 4), generator=g, device=device)[keep]
    data = torch.zeros((nb, slots, 8), dtype=torch.int32, device=device)
    at = (bucket[keep], slot[keep])
    data[at + (0,)] = _int32(lo[keep])
    data[at + (1,)] = _int32(hi[keep])
    data[at[0], at[1], 2:6] = q.view(torch.int32)
    return data.view(nb, slots * 8), int(keep.sum())


def _int32(words: torch.Tensor) -> torch.Tensor:
    """32-bit words held in int64, as the int32 of the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class Table:
    """The table as dicts, loaded bucket by bucket from ``base`` (the rows
    of :func:`fill`) when a step first reads a bucket."""

    def __init__(self, cfg, base, quant=None):
        self.n_buckets = (1 << cfg["capacity_log2"]) // cfg["bucket_slots"]
        self.slots = cfg["bucket_slots"]
        self.quant = quant
        self.base = base
        self.buckets = {}  # bucket -> [key, ...] in slot order
        self.q = {}  # key -> (4,) float32
        self.loaded = set()
        self.dropped = 0
        self.claims = 0

    def load(self, buckets):
        """Read the buckets not yet read from ``base``, in one gather."""
        new = sorted(set(buckets) - self.loaded)
        if not new:
            return
        self.loaded.update(new)
        rows = self.base[torch.tensor(new, device=self.base.device)]
        rows = rows.view(len(new), self.slots, 8).cpu().numpy()
        lo = rows[:, :, 0].view(np.uint32).astype(np.int64)
        hi = rows[:, :, 1].view(np.uint32).astype(np.int64)
        q = rows[:, :, 2:6].view(np.float32)
        for i, b in enumerate(new):
            held = [int(h) << 32 | int(lo_) for lo_, h in zip(lo[i], hi[i])
                    if lo_ or h]
            if held:
                self.buckets[b] = held
                for s, k in enumerate(held):
                    self.q[k] = q[i, s].copy()

    def _store(self, row):
        if self.quant == "bf16":
            row = torch.from_numpy(row).to(torch.bfloat16).float().numpy()
        return row.astype(np.float32)

    def rows(self, keys):
        zero = np.zeros(4, np.float32)
        return np.stack([self.q.get(k, zero) for k in keys])

    def update(self, keys, buckets, actions, deltas):
        """One batch's updates (``deltas`` already ``lr * (target - q)``)."""
        groups = {}
        for i, (k, b) in enumerate(zip(keys, buckets)):
            held = self.buckets.get(b, [])
            g = groups.setdefault(b, {"claim": None, "sums": {}})
            if k in held:
                slot_key = k
            elif len(held) < self.slots and g["claim"] in (None, k):
                g["claim"] = k
                slot_key = k
            else:
                self.dropped += 1
                continue
            sums = g["sums"].setdefault(slot_key,
                                        [np.float32(0)] * 4)
            a = actions[i]
            sums[a] = np.float32(sums[a] + deltas[i])
        zero = np.zeros(4, np.float32)
        for b, g in groups.items():
            if g["claim"] is not None:
                self.buckets.setdefault(b, []).append(g["claim"])
                self.claims += 1
            for k, sums in g["sums"].items():
                base = self.q.get(k, zero)
                self.q[k] = self._store(base + np.array(sums, np.float32))


def epsilon(episodes_done: int, lanes: int, cfg, device) -> torch.Tensor:
    """The reference's four-phase decay (30% / 60% / 80% of
    ``total_epochs``) at epoch = finished episodes / lanes, in float32."""
    t = float(cfg["total_epochs"])
    e0, emin = cfg["exploration_rate"], cfg["exploration_min"]
    b1, b2, b3 = 0.30 * t, 0.60 * t, 0.80 * t
    slow1 = (e0 - emin * 1.5) / b1
    fast = ((e0 - emin) - emin * 1.5) / (b2 - b1)
    slow2 = (emin * 1.1 - emin) / (b3 - b2)
    n1, n2, n3 = math.ceil(b1), math.ceil(b2), math.ceil(b3)
    epoch = torch.tensor(episodes_done, dtype=torch.int32,
                         device=device).to(torch.float32) / lanes
    k1 = epoch.clamp(0.0, n1)
    k2 = (epoch - n1).clamp(0.0, n2 - n1)
    k3 = (epoch - n2).clamp(0.0, n3 - n2)
    eps = (e0 - slow1 * k1).clamp_min(emin * 1.5)
    eps = torch.where(k2 > 0, (eps - fast * k2).clamp_min(emin * 1.1), eps)
    eps = torch.where(k3 > 0, (eps - slow2 * k3).clamp_min(emin), eps)
    return torch.where(epoch > n3, emin, eps)


def _norm(r):
    pos = torch.clamp_max(torch.log2(r + 1.0), 10.0)
    neg = -torch.clamp_max(torch.log2(torch.abs(r - 1.0)), 10.0)
    return torch.where(r >= 0, pos, neg)


def shaped_reward(score, valid, over, max_number, prev_max):
    """``Game2048_env.py``'s level-progress reward, normalized by a signed
    log2 capped at 10; returns it and the new running best tile."""
    score = score.to(torch.float32)
    max_number = torch.clamp_min(max_number, 2)
    level = torch.log2(max_number.to(torch.float32))
    level_pow = level ** 1.2
    improved = max_number > prev_max
    bonus = torch.where(
        improved,
        (level - torch.log2(torch.clamp_min(prev_max, 1).to(torch.float32)))
        * level_pow, 0.0)
    new_prev = torch.where(improved, max_number, prev_max)
    milestone = ((max_number == 512) | (max_number == 1024)
                 | (max_number == 2048))
    bad_end = torch.where(milestone, bonus + level_pow,
                          -torch.log2((max_number + 1).to(torch.float32)))
    bad = torch.where(over, bad_end, -0.1 * level)
    good = (score + torch.where(bonus > 0, bonus, level * 0.05)
            + torch.where(max_number >= 512, level_pow * 2.0, 0.0))
    return _norm(torch.where(valid, good, bad)), new_prev


def follow(cfg, traffic, base, board, words, draws, quant=None):
    """Train from the filled table ``base`` on ``board`` (``(B, 16)``) for
    ``len(words)`` steps, each on its ``(8, B)`` kernel words and its
    ``(explore uniforms, random actions)`` draws. Returns the table and the
    final lanes."""
    b = board.shape[0]
    dev = board.device
    table = Table(cfg, base, quant)
    lanes = dict(
        board=board, score=torch.zeros(b, dtype=torch.int64, device=dev),
        steps=torch.zeros(b, dtype=torch.int64, device=dev),
        prev_max=torch.full((b,), 2, dtype=torch.int64, device=dev),
        consec_action=torch.full((b,), -1, dtype=torch.int64, device=dev),
        consec_count=torch.zeros(b, dtype=torch.int64, device=dev),
        penalty=torch.full((b,), -1.0, device=dev))
    episodes = 0
    action_counts = np.zeros(4, np.int64)
    lr, gamma = np.float32(cfg["learning_rate"]), np.float32(cfg["discount"])
    for w, (explore_u, rand_action) in zip(words, draws):
        brd = lanes["board"]
        lo, hi = pack(brd)
        ks = keys(lo, hi)
        buckets = bucket_of(lo, hi, table.n_buckets).tolist()
        table.load(buckets)
        q_s = table.rows(ks)
        eps = epsilon(episodes, b, cfg, dev)
        greedy = torch.from_numpy(q_s.argmax(1)).to(dev)
        action = torch.where(explore_u.to(dev) < eps,
                             rand_action.to(dev).to(torch.int64), greedy)
        same = action == lanes["consec_action"]
        count = torch.where(same, lanes["consec_count"] + 1, 1)
        out = game.word_step(brd, action, w.to(dev),
                             count > traffic["stall_force_done"])
        max_number = game.values(out["max_exp"])
        reward, prev_max = shaped_reward(out["score"], out["moved"],
                                         out["game_over"], max_number,
                                         lanes["prev_max"])
        penalty = torch.where(same, lanes["penalty"], -1.0)
        stalled = count > traffic["max_consecutive_actions"]
        step_pen = torch.clamp_min(penalty * 1.1, -10.0)
        penalty = torch.where(stalled, step_pen, penalty)
        reward = reward + torch.where(stalled, step_pen, 0.0)
        nlo, nhi = pack(out["new"])
        table.load(bucket_of(nlo, nhi, table.n_buckets).tolist())
        q_next = table.rows(keys(nlo, nhi))
        r = reward.cpu().numpy().astype(np.float32)
        done = out["done"]
        d = done.cpu().numpy().astype(np.float32)
        targets = r + gamma * q_next.max(1) * (np.float32(1) - d)
        act = action.cpu().numpy()
        q_sa = q_s[np.arange(b), act]
        table.update(ks, buckets, act, lr * (targets - q_sa))
        episodes += int(done.sum())
        np.add.at(action_counts, act, 1)
        score = lanes["score"] + out["score"]
        steps = lanes["steps"] + 1
        lanes.update(
            board=out["final"], prev_max=prev_max, consec_action=action,
            consec_count=count, penalty=penalty,
            score=torch.where(done, 0, score),
            steps=torch.where(done, 0, steps))
    lanes["episodes"] = episodes
    lanes["action_counts"] = action_counts
    return table, lanes


def table_view(table: Table):
    """The stored keys of the buckets read as arrays: bucket, slot, key
    words and Q rows."""
    bk, slot, lo, hi, q = [], [], [], [], []
    for b, keys in table.buckets.items():
        for s, k in enumerate(keys):
            bk.append(b)
            slot.append(s)
            lo.append(k & M32)
            hi.append(k >> 32)
            q.append(table.q.get(k, np.zeros(4, np.float32)))
    q = np.stack(q) if q else np.zeros((0, 4), np.float32)
    return (np.array(bk, np.int64), np.array(slot, np.int64),
            np.array(lo, np.int64), np.array(hi, np.int64), q)
