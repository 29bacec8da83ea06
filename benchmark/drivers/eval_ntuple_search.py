"""Traffic ``eval_ntuple_search``: the n-tuple network played by depth-D
expectimax, the port's ``eval/evaluate.py::evaluate`` with
``expectimax_ntuple_policy(net, depth)`` on the fast engine in simple mode,
calls back to back, ``games`` games at batch ``batch`` a call.

Set-up first imports the port's search, so that a port without it fails at
once. It then fills the table as the traffic ``train_ntuple`` trains it,
through that traffic's driver: zero weights, the fill's ``warm_lane_steps``
of the port's ``train_chunk``, then its ``check_steps`` steps one at a time,
each copied before it so that the reference can derive it again (the table
both sides search is the program's, so its last steps are held to the
reference too). It plays one call, and then replays ``check_steps`` steps of
that call one at a time, drawn from the seed, reading the program's leaf
counter before and after each. The window plays whole calls until
``--seconds`` have passed; a move is a step of a game not yet over (a
finished lane is still searched, and makes no move), so the rate is the
games' lengths over the window. The window's counts give the live share and
the leaves a second.

The policy is the port's, wrapped so that each step's boards, legal masks
and actions are kept by reference (no device work), as are the env's words
and, at ``value_steps`` steps of each call drawn from the seed before any
call, the four root values that the port's search returned on the timed
path. Once the window has closed the reference checks:

* ``env_mismatch``: every board of every step against the reference's step
  from the board before on the port's action and the recorded words (the
  first against the reset words' fresh board), each legal mask, and each
  game's latched score, largest tile and length;
* ``value_gap``: at ``q_positions`` positions drawn from the seed among the
  moves of the kept steps, the values the timed call returned (at batch
  ``batch``) against the reference's float32 tree, as ``|got - want| /
  max(1, |want|)``;
* ``action_mismatch``: positions where the reference's two best values lie
  further apart than ``value_gap``'s limit and the recorded action is not
  its first maximum, and positions where the search run again on those
  boards alone differs from the timed call in its values or action (the
  kernels are deterministic and a root's values do not depend on the other
  lanes);
* ``leaf_mismatch``: over the replayed steps, the program's counter against
  the reference's count of the trees' leaves;
* ``fill_*``: the fill's checked steps, as ``ntuple_train`` checks its own
  (``value_gap``, ``action_mismatch``, ``lut_gap``, ``env_mismatch``).
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import torch

from benchmark import core
from benchmark.counts import search_work
from benchmark.reference import game

SPANS = ("ntuple.search", "eval.policy", "eval.env_step")
BLOCK = 1 << 18  # boards a block of the reference's step checks
REF_ROOTS = 64  # roots a block of the reference's trees
STEPS_PER_CHUNK = 32  # evaluate's steps between its host checks


class Driver:
    spans = SPANS
    faults = ("p4_half", "shallow")  # planted in the reference in its place

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")
        self.patterns = [list(p) for p in self.cfg["patterns"]]
        self.depth = int(self.cfg["depth"])
        self._cache = {}

    def setup(self):
        from tpu2048_torch.eval.evaluate import expectimax_ntuple_policy
        from tpu2048_torch.agents import ntuple as agent
        from tpu2048_torch.ops import ntuple_kernel as nk
        from tpu2048_torch.env import fast as fastlib
        from tpu2048_torch.env.env import SIMPLE, EnvConfig
        from tpu2048_torch.eval import evaluate as ev
        from tpu2048_torch.models.ntuple import NTupleNetwork

        self.ev, self.nk, self.fastlib = ev, nk, fastlib
        self.agent = agent
        self.net_cls = NTupleNetwork
        self.fill = self._fill()
        self.net = NTupleNetwork(tuple(map(tuple, self.patterns)),
                                 self.device, self.fill.net.weights)
        self.fill.release()
        self.weights = self.fill.after_check["lut"]  # the table, on the host
        search = expectimax_ntuple_policy(self.net, self.depth)
        g = torch.Generator().manual_seed(core.derive(self.seed, 4))
        call_steps = (self.traffic["max_steps"] // STEPS_PER_CHUNK + 1) \
            * STEPS_PER_CHUNK
        self.value_steps = set(torch.randperm(call_steps, generator=g)[
            :self.own["value_steps"]].tolist())
        self.steps, self.values, self._first, self._last = [], {}, 0, None

        def recorded(params, boards, legal):
            self._last = None
            actions = search(boards, legal)
            if len(self.steps) - self._first in self.value_steps:
                self.values[len(self.steps)] = self._last
            self.steps.append((boards, legal, actions))
            return actions

        self.policy = ev.Policy(fn=recorded)
        self.bits = core.Recording(fastlib.GeneratorBits(
            core.derive(self.seed, 1), self.device))
        self.env = EnvConfig(reward=SIMPLE, auto_reset=False)
        self._call()
        self.leaf_checks = self._replay_steps(search)
        self.calls = []
        self.steps, self.values, self.bits.calls = [], {}, []

    def _fill(self):
        """The traffic ``train_ntuple``'s driver at the fill's parameters,
        set up: the table trained from zero weights, its checked steps
        copied."""
        driver = core.load_module(self.cell.bench / "drivers"
                                  / "train_ntuple.py").Driver
        cell = SimpleNamespace(
            config=dict(self.cfg, reference="ntuple"),
            traffic=self.traffic["fill"],
            own=dict(limits=self.own["fill_limits"]))
        fill = driver(cell, core.derive(self.seed, 2), self.device)
        fill.setup()
        return fill

    def _replay_steps(self, search):
        """``check_steps`` steps of the set-up call, drawn from the seed,
        searched again one at a time: each step's boards and the leaves
        the program's counter advanced by."""
        g = torch.Generator().manual_seed(core.derive(self.seed, 3))
        picks = torch.randperm(len(self.steps), generator=g)[
            :self.traffic["check_steps"]].tolist()
        counter = self.nk.leaf_counter(self.device)
        out = []
        for i in sorted(picks):
            boards, legal, _ = self.steps[i]
            before = int(counter)
            search(boards, legal)
            out.append((boards.reshape(-1, 16).to(torch.int64),
                        int(counter) - before))
        return out

    def _call(self, max_steps=None):
        """One call of ``evaluate``, the root values of the port's search
        (``agents/ntuple.py::expectimax_search``, which the policy's
        actions come from) kept for the recorder; returns its result and
        where its recordings start."""
        tr = self.traffic
        first = (len(self.steps), len(self.bits.calls))
        self._first = first[0]
        search = self.agent.expectimax_search

        def kept(*args, **kw):
            out = search(*args, **kw)
            self._last = out.values
            return out

        self.agent.expectimax_search = kept
        try:
            res = self.ev.evaluate(self.policy, tr["games"], self.bits,
                                   self.env, tr["batch"],
                                   max_steps or tr["max_steps"],
                                   engine="fast")
        finally:
            self.agent.expectimax_search = search
        return res, first

    def run(self, seconds: float):
        counter = self.nk.leaf_counter(self.device)
        leaves0 = int(counter)
        t0 = time.perf_counter()
        while True:
            self.calls.append(self._call())
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.device)
        dt = time.perf_counter() - t0
        moves = int(sum(r.lengths.sum() for r, _ in self.calls))
        lane_steps = sum(r.env_steps for r, _ in self.calls)
        leaves = int(counter) - leaves0
        self.window = dict(calls=len(self.calls), moves=moves,
                           lane_steps=lane_steps,
                           live_share=moves / lane_steps, leaves=leaves,
                           leaves_per_s=leaves / dt)
        return {"env_steps_per_s": moves / dt}, moves

    def _calls(self, max_steps):
        """One call of at most ``max_steps`` steps; returns its result and
        the root boards of its steps."""
        first = len(self.steps)
        self.calls.append(self._call(max_steps))
        return self.calls[-1][0], [b for b, _, _ in self.steps[first:]]

    def run_traced(self, tracer):
        """One call of at most ``trace.steps`` steps timed without the
        profiler, then one under it: whole calls, as the window plays them,
        so that the traced steps' trees and live share are the window's.
        The leaves are the program's counter over the traced call. The
        trees' least work is counted from the roots of ``trace.chunks``
        runs of ``trace.chunk_steps`` steps spread evenly over the call,
        and the roofline's reader times those steps' search kernels alone.
        The env step's ``valid`` and ``done`` outputs are kept by reference
        to count the step kernel's spawns and resets."""
        tr = self.own["trace"]
        (plain, _), plain_s = tracer.timed(lambda: self._calls(tr["steps"]))
        counter = self.nk.leaf_counter(self.device)
        before = int(counter)
        kept = []
        fast_step = self.fastlib.fast_step

        def counted(*args, **kw):
            state, ts = fast_step(*args, **kw)
            kept.append((ts.valid, ts.done))
            return state, ts

        self.fastlib.fast_step = counted
        try:
            with tracer as t:
                traced, roots = self._calls(tr["steps"])
        finally:
            self.fastlib.fast_step = fast_step
        leaves = int(counter) - before
        counted_steps = _spread(len(roots), tr["chunks"], tr["chunk_steps"])
        work = dict(leaves=0, distinct_leaves=0, distinct_weights=0)
        for i in counted_steps:
            step = search_work.step_work(roots[i].reshape(-1, 16).to(
                torch.int64), self.patterns, self.depth)
            for key in work:
                work[key] += step[key]
        b = self.traffic["batch"]
        n_bytes = search_work.search_bytes(len(counted_steps) * b,
                                           work["distinct_weights"])
        n_ops = search_work.search_ops(work["distinct_leaves"],
                                       8 * len(self.patterns))
        moves = int(traced.lengths.sum())
        self.window = dict(
            steps=traced.batch_steps, moves=moves,
            live_share=moves / traced.env_steps, program_leaves=leaves,
            leaves_per_step=leaves / traced.batch_steps,
            counted_steps=len(counted_steps),
            enumerated_leaves=work["leaves"],
            distinct_leaves=work["distinct_leaves"],
            distinct_weights=work["distinct_weights"], search_bytes=n_bytes,
            search_ops=n_ops,
            roofline_bound=search_work.least_s(n_bytes, n_ops)[1])
        return t.summary(dict(
            plain_s=plain_s, plain_pace=plain.batch_steps,
            pace=traced.batch_steps, work=moves, moves=moves,
            lane_steps=traced.batch_steps * b,
            spawns=int(sum(v.sum() for v, _ in kept)),
            resets=int(sum(d.sum() for _, d in kept)), emit_legal=True,
            search_leaves=leaves, search_steps=counted_steps,
            search_bytes=n_bytes, search_ops=n_ops))

    def release(self):
        self.policy = None
        self.net = None

    # -- the comparison ----------------------------------------------------

    def _segments(self):
        """Each call's first step, recorded steps and words."""
        ends = [first for _, first in self.calls[1:]] + [
            (len(self.steps), len(self.bits.calls))]
        for (res, (s0, w0)), (s1, w1) in zip(self.calls, ends):
            yield res, s0, self.steps[s0:s1], self.bits.calls[w0:w1]

    def _env_check(self):
        """``env_mismatch`` over every call, and the positions drawn for
        the values: ``(boards, actions, values)`` of ``q_positions`` moves
        of the kept steps, the values ``(4, N)`` as the timed call returned
        them (NaN where it returned none)."""
        dev, b = self.device, self.traffic["batch"]
        bad = 0
        positions = []
        for res, s0, steps, words in self._segments():
            boards = torch.stack([s[0].reshape(b, 16) for s in steps]
                                 ).to(torch.int64)  # (T, B, 16)
            legal = torch.stack([s[1] for s in steps])
            actions = torch.stack([s[2] for s in steps]).to(torch.int64)
            w = torch.stack(words[1:]).to(torch.int64)  # (T, 8, B)
            fresh = game.word_fresh(*words[0].to(torch.int64)[4:8])
            bad += int((boards[0] != fresh).any(1).sum())
            n, t_len = b * len(steps), len(steps)
            flat_b, flat_a = boards.reshape(n, 16), actions.reshape(n)
            flat_w = w.permute(1, 0, 2).reshape(8, n)
            outs = {k: [] for k in ("final", "score", "done", "max_exp")}
            for i in range(0, n, BLOCK):
                o = game.word_step(flat_b[i:i + BLOCK], flat_a[i:i + BLOCK],
                                   flat_w[:, i:i + BLOCK])
                for k in outs:
                    outs[k].append(o[k])
                bad += int((game.legal(flat_b[i:i + BLOCK])
                            != legal.reshape(n, 4)[i:i + BLOCK])
                           .any(1).sum())
            o = {k: torch.cat(v).reshape(t_len, b, *v[0].shape[1:])
                 for k, v in outs.items()}
            bad += int((o["final"][:-1] != boards[1:]).any(2).sum())
            # Each lane's first game: score, largest tile and length; a game
            # that the call's last step left running stands as that step
            # left it (its board before any reset).
            done = o["done"]
            ended = done.any(0)
            first = torch.where(ended, done.to(torch.int8).argmax(0),
                                t_len - 1)
            before = torch.arange(t_len, device=dev)[:, None] <= first
            score = (o["score"] * before).sum(0)
            lanes = torch.arange(b, device=dev)
            tile = game.values(o["max_exp"][first, lanes])
            length = torch.where(ended, first + 1, t_len)
            for got, want in ((res.scores, score), (res.max_tiles, tile),
                              (res.lengths, length)):
                bad += int((torch.as_tensor(got, device=dev) != want).sum())
            for t in range(t_len):
                if s0 + t not in self.values:
                    continue
                values = self.values[s0 + t]
                if values is None:
                    values = torch.full((4, b), torch.nan, device=dev)
                live = before[t]
                positions.append((boards[t][live], actions[t][live],
                                  values[:, live].to(dev)))
        pb, pa = (torch.cat([x[i] for x in positions]) for i in (0, 1))
        pv = torch.cat([x[2] for x in positions], 1)
        g = torch.Generator(device="cpu").manual_seed(
            core.derive(self.seed, 5))
        pick = torch.randperm(pb.shape[0], generator=g)[
            :self.own["q_positions"]].to(dev)
        return bad, pb[pick], pa[pick], pv[:, pick]

    def _reference(self, weights, boards, quant=None):
        """The reference's tree of ``boards`` (``(N, 16)`` int64), in the
        program's place where ``quant`` names the control or a fault: the
        control reads bf16 weights, ``p4_half`` spawns a 4 with p = 0.5,
        ``shallow`` puts the leaves one max layer higher."""
        depth, spawns = self.depth, self.ref.SPAWNS
        if quant == self.cfg["control"]:
            weights = weights.to(torch.bfloat16)
        elif quant == "p4_half":
            spawns = ((1, 0.5), (2, 0.5))
        elif quant == "shallow":
            depth -= 1
        out = self.ref.search(weights, self.patterns, boards, depth, spawns,
                              roots=REF_ROOTS)
        return dict(values=out["values"].float(), action=out["action"],
                    leaves=out["leaves"])

    def _program(self, weights, boards):
        """The port's search run again on ``boards`` alone: its values and
        actions."""
        net = self.net_cls(tuple(map(tuple, self.patterns)), self.device,
                           weights.view(len(self.patterns), -1))
        cm = boards.to(torch.int8).T.contiguous()
        out = self.nk.search_values(cm, net.weights, net.maps, self.depth)
        return out.values, out.action.to(torch.int64)

    def check(self, quant=None):
        lim = self.own["limits"]
        weights = self.weights.to(self.device).view(-1)
        if "env" not in self._cache:
            self._cache["env"] = self._env_check()
            _, pb, _, _ = self._cache["env"]
            self._cache["want"] = self._reference(weights, pb)
            self._cache["want_leaves"] = [
                int(self._reference(weights, boards)["leaves"].sum())
                for boards, _ in self.leaf_checks]
        env_bad, pb, pa, pv = self._cache["env"]
        want = self._cache["want"]
        if quant is None:
            again_values, again = self._program(weights, pb)
            values, action = pv, pa
            stale = int(((again != pa) | (again_values != pv).any(0)).sum())
            leaves = [n for _, n in self.leaf_checks]
        else:
            got = self._reference(weights, pb, quant)
            values, action, stale = got["values"], got["action"], 0
            leaves = [int(self._reference(weights, boards, quant)["leaves"]
                          .sum()) for boards, _ in self.leaf_checks]
        q = want["values"]
        top = q.topk(2, dim=0).values
        clear = (top[0] - top[1]) / top[0].abs().clamp_min(1) > lim[
            "value_gap"]
        action_bad = stale + int((clear & (action != want["action"])).sum())
        leaf_bad = sum(abs(a - b) for a, b in
                       zip(leaves, self._cache["want_leaves"]))
        fill = [(f"fill_{name}", value, limit)
                for name, value, limit in self.fill.check(quant)]
        return [("env_mismatch", env_bad if quant is None else 0,
                 lim["env_mismatch"]),
                ("value_gap", _gap(values, q), lim["value_gap"]),
                ("action_mismatch", action_bad, lim["action_mismatch"]),
                ("leaf_mismatch", leaf_bad, lim["leaf_mismatch"])] + fill


def _spread(n: int, chunks: int, size: int):
    """``chunks`` runs of ``size`` consecutive indices of ``range(n)``,
    spread evenly from its start to its end; all of it where they would
    cover it."""
    if chunks * size >= n:
        return list(range(n))
    starts = [round(i * (n - size) / max(chunks - 1, 1))
              for i in range(chunks)]
    return [s + j for s in starts for j in range(size)]


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want| / max(1, |want|)``; two equal infinities
    are no gap, any other infinity or NaN an infinite one."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    same_inf = torch.isinf(want) & (got == want)
    diff = torch.where(same_inf, 0.0, (got - want).abs()
                       / want.abs().clamp_min(1))
    diff = torch.where(torch.isnan(diff), torch.inf, diff)
    return float(diff.max()) if diff.numel() else 0.0
