"""Traffic ``train_tabular``: the ``train tabular`` loop, the port's
``training/tabular.py::train_chunk`` called back to back on one state.

Set-up builds the state from the configuration (``init_train_state``: fresh
boards and a table of ``2**capacity_log2`` slots), with the port's own env
and agent sources seeded by the benchmark, fills the table as the traffic's
``fill`` says (the reference's :func:`fill`: the boards random play
reaches, to the run of record's count of keys, so that buckets are full
and updates drop as in a long run), and runs one warm chunk. The window
runs whole chunks until ``--seconds`` have passed; every lane makes a move
each step (a finished game restarts in the same step), so the rate is
lanes times steps over the window.

The comparison follows the warm chunk: from the same filled table and the
recorded env words and agent draws, the reference trains its own table,
lane by lane, and at the end of the chunk compares every slot of each
bucket that either side read or wrote (keys and Q-values) with the port's
table, the count of stored keys and of dropped updates, and the lanes of
the env (boards, scores, lengths, the shaping and stall lanes) and the
episode and action counts.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import core, port
from benchmark.reference import game

SPANS = ("bench.train_chunk",)


class Driver:
    spans = SPANS

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    def setup(self):
        from tpu2048_torch.agents import tabular_fast as tabf
        from tpu2048_torch.env import fast as fastlib
        from tpu2048_torch.training import tabular as ttrain

        self.ttrain, self.fastlib = ttrain, fastlib
        self.config = port.tabular_config(self.cfg, self.traffic)
        self.bits = core.Recording(fastlib.GeneratorBits(
            core.derive(self.seed, 1), self.device))
        self.draws = core.Recording(tabf.GeneratorDraws(
            core.derive(self.seed, 2), self.device))
        st = ttrain.init_train_state(self.config, self.bits)
        base, _ = self._fill()
        st.table.data[:-1].copy_(base)
        st, _ = ttrain.train_chunk(self.config, st, self.bits, self.draws)
        self.bits.on = self.draws.on = False
        self.after_warm = self._snapshot(st, base)
        self.state = st

    def _fill(self):
        return self.ref.fill(self.cfg, self.traffic["fill"],
                             core.derive(self.seed, 4), self.device)

    @torch.no_grad()
    def _snapshot(self, st, base):
        """What the warm chunk produced: the table's buckets that differ
        from the filled table it started from (ids and rows), its stored
        and dropped counts, the env lanes and the counters; copies, since
        the window goes on writing the table."""
        data = st.table.data[:-1]
        rows = torch.nonzero((data != base).any(1))[:, 0]
        used = (data[:, 0::8] != 0) | (data[:, 1::8] != 0)
        env = st.env_state
        lanes = {f.name: getattr(env, f.name).clone()
                 for f in dataclasses.fields(env) if f.name != "legal"}
        return dict(rows=rows, data=data[rows].clone(),
                    stored=int(used.sum()), dropped=int(st.table.dropped),
                    episodes=int(st.episodes_done),
                    action_counts=st.action_counts.cpu().numpy(),
                    lanes=lanes)

    def run(self, seconds: float):
        st = self.state
        steps = 0
        t0 = time.perf_counter()
        while True:
            st, _ = self.ttrain.train_chunk(self.config, st, self.bits.inner,
                                            self.draws.inner)
            steps += self.config.steps_per_chunk
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.device)
        dt = time.perf_counter() - t0
        self.state = st
        moves = steps * self.config.batch_size
        return {"env_steps_per_s": moves / dt}, moves

    def run_traced(self, tracer):
        """One chunk of ``trace.steps`` steps timed without the profiler,
        then one under it. The env step's ``valid`` and ``done`` outputs are
        kept by reference (no device work) to count the step kernel's
        spawns and resets."""
        steps = self.own["trace"]["steps"]
        one = dataclasses.replace(self.config, steps_per_chunk=steps)
        kept = []
        fast_step = self.fastlib.fast_step

        def counted(*args, **kw):
            state, ts = fast_step(*args, **kw)
            kept.append((ts.valid, ts.done))
            return state, ts

        def chunk():
            with record_function("bench.train_chunk"):
                self.state, _ = self.ttrain.train_chunk(
                    one, self.state, self.bits.inner, self.draws.inner)

        _, plain_s = tracer.timed(chunk)
        self.fastlib.fast_step = counted
        try:
            with tracer as t:
                chunk()
        finally:
            self.fastlib.fast_step = fast_step
        b = self.config.batch_size
        spawns = int(sum(v.sum() for v, _ in kept))
        resets = int(sum(d.sum() for _, d in kept))
        return t.summary(dict(plain_s=plain_s, plain_pace=steps, pace=steps,
                              work=steps * b, steps=steps, lanes=b,
                              lane_steps=steps * b,
                              spawns=spawns, resets=resets,
                              emit_legal=False, gathers=2 * steps,
                              scatters=steps))

    def release(self):
        self.state = None

    def check(self, quant=None):
        snap, lim = self.after_warm, self.own["limits"]
        words = [w.to(torch.int64) for w in self.bits.calls]
        board = game.word_fresh(*words[0][4:8])
        base, stored = self._fill()
        table, lanes = self.ref.follow(self.cfg, self.traffic, base, board,
                                       words[1:], self.draws.calls)
        if quant is None:
            got = _program_view(snap)
        else:
            got = _reference_view(self.ref, stored, *self.ref.follow(
                self.cfg, self.traffic, base, board, words[1:],
                self.draws.calls, quant))
        want = _reference_view(self.ref, stored, table, lanes)
        env_bad = sum(int((got["lanes"][k] != want["lanes"][k]).sum())
                      for k in want["lanes"])
        env_bad += int(got["episodes"] != want["episodes"])
        env_bad += int((got["action_counts"] != want["action_counts"]).sum())
        key_bad, q_gap = _compare_tables(got, want, base)
        return [("env_mismatch", env_bad, lim["env_mismatch"]),
                ("table_mismatch", key_bad, lim["table_mismatch"]),
                ("q_gap", q_gap, lim["q_gap"])]


LANES = ("board", "score", "steps", "prev_max", "consec_action",
         "consec_count", "penalty")


def _program_view(snap):
    """The warm chunk's output of the port, in the reference's terms: the
    rows of the buckets it changed in the table's layout (a bucket is a row
    of 128 words, slot ``j`` its words ``[8j, 8j + 8)``: key words, four
    float32 Q-values, two pads), the counts and the env lanes."""
    env = snap["lanes"]
    b = env["boards"].shape[1]
    lanes = dict(board=env["boards"].T.reshape(b, 16),
                 score=env["score"], steps=env["episode_steps"],
                 prev_max=env["prev_max"],
                 consec_action=env["consec_action"],
                 consec_count=env["consec_count"],
                 penalty=env["last_consec_penalty"])
    return dict(rows=snap["rows"].cpu().numpy(),
                data=snap["data"].view(-1, 16, 8).cpu().numpy(),
                stored=snap["stored"], dropped=snap["dropped"],
                episodes=snap["episodes"],
                action_counts=snap["action_counts"],
                lanes={k: _host(lanes[k]) for k in LANES})


def _reference_view(ref, filled, table, lanes):
    """A reference table and its lanes in the terms of
    :func:`_program_view`: the rows of every bucket it read, and the count
    of keys stored (``filled`` at the start)."""
    rows = np.array(sorted(table.loaded), np.int64)
    bk, slot, lo, hi, q = ref.table_view(table)
    at = np.searchsorted(rows, bk)
    data = np.zeros((len(rows), 16, 8), np.int32)
    data[at, slot, 0] = lo.astype(np.uint32).view(np.int32)
    data[at, slot, 1] = hi.astype(np.uint32).view(np.int32)
    data[at, slot, 2:6] = q.view(np.int32)
    return dict(rows=rows, data=data, stored=filled + table.claims,
                dropped=table.dropped,
                episodes=lanes["episodes"],
                action_counts=lanes["action_counts"],
                lanes={k: _host(lanes[k]) for k in LANES})


def _host(t):
    t = t.cpu()
    return t if t.is_floating_point() else t.to(torch.int64)


def _compare_tables(got, want, base):
    """Slots out of place over every bucket either side holds (a bucket
    one side leaves out is the filled table's there), with the differences
    of the stored and dropped counts; and the largest Q gap of a key both
    hold at one slot, over the larger of 1 and the largest Q-value."""
    bad = abs(got["stored"] - want["stored"]) + abs(
        got["dropped"] - want["dropped"])
    ids = np.union1d(got["rows"], want["rows"])
    if not len(ids):
        return bad, 0.0
    filled = base[torch.from_numpy(ids).to(base.device)]
    filled = filled.view(len(ids), 16, 8).cpu().numpy()
    g, w = filled.copy(), filled
    g[np.searchsorted(ids, got["rows"])] = got["data"]
    w[np.searchsorted(ids, want["rows"])] = want["data"]
    same = (g[:, :, 0] == w[:, :, 0]) & (g[:, :, 1] == w[:, :, 1])
    bad += int((~same).sum())
    stored = same & ((w[:, :, 0] != 0) | (w[:, :, 1] != 0))
    q = w[:, :, 2:6][stored].view(np.float32).astype(np.float64)
    gq = g[:, :, 2:6][stored].view(np.float32).astype(np.float64)
    if not len(q):
        return bad, 0.0
    return bad, float(np.abs(gq - q).max()) / max(1.0, float(np.abs(q).max()))
