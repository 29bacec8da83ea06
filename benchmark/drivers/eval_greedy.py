"""Traffic ``eval_greedy``: greedy DQN evaluation, the port's
``eval/evaluate.py::evaluate`` with ``greedy_dqn_policy``, calls back to
back, ``games`` games at batch ``batch`` a call.

Set-up builds the port's Q-network with the benchmark's weights and plays
one call. The window plays whole calls until ``--seconds`` have passed; a
move is a step of a game not yet over (a finished lane that the batch
still computes is no move), so the rate is the games' lengths over the
window.

The policy is the port's, wrapped so that each step's boards, legal masks
and actions are kept by reference (no device work), as are the env's
words. Once the window has closed the reference checks every step of every
call: each board against the reference's step from the board before on
the port's action and the recorded words (the first against the fresh
board of the reset words), each legal mask, and each game's latched score,
largest tile and length. It judges the greedy choice at ``q_positions``
positions drawn from the seed among the moves, by the gap of the chosen
action's Q-value below the best legal one under the float32 network.
"""

from __future__ import annotations

import importlib
import time

import torch
from torch.profiler import record_function

from benchmark import core, judge, port
from benchmark.counts import flops
from benchmark.reference import game

SPANS = ("bench.evaluate",)
BLOCK = 1 << 18  # boards a block of the reference's checks


class Driver:
    spans = SPANS

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    def setup(self):
        from tpu2048_torch.env import fast as fastlib
        from tpu2048_torch.env.env import SIMPLE, EnvConfig
        from tpu2048_torch.eval import evaluate as ev

        self.ev, self.fastlib = ev, fastlib
        weights = core.weights(self.ref, self.cfg, self.device)
        greedy = ev.greedy_dqn_policy(
            port.dqn_model(self.cfg, weights, self.device))
        self.steps = []

        def recorded(params, boards, legal):
            actions = greedy(boards, legal)
            self.steps.append((boards, legal, actions))
            return actions

        self.policy = ev.Policy(fn=recorded)
        self.bits = core.Recording(fastlib.GeneratorBits(
            core.derive(self.seed, 1), self.device))
        self.env = EnvConfig(reward=SIMPLE, auto_reset=False)
        self._call()
        self.calls = []
        self.steps, self.bits.calls = [], []

    def _call(self):
        tr = self.traffic
        first = (len(self.steps), len(self.bits.calls))
        res = self.ev.evaluate(self.policy, tr["games"], self.bits,
                               self.env, tr["batch"], tr["max_steps"],
                               engine="fast")
        return res, first

    def run(self, seconds: float):
        t0 = time.perf_counter()
        while True:
            self.calls.append(self._call())
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.device)
        dt = time.perf_counter() - t0
        moves = int(sum(r.lengths.sum() for r, _ in self.calls))
        return {"env_steps_per_s": moves / dt}, moves

    def _calls(self):
        """``trace.calls`` calls; returns their results."""
        n = self.own["trace"]["calls"]
        for _ in range(n):
            with record_function("bench.evaluate"):
                self.calls.append(self._call())
        return [r for r, _ in self.calls[-n:]]

    def run_traced(self, tracer):
        """``trace.calls`` calls timed without the profiler, then as many
        under it; the env step's ``valid`` and ``done`` outputs are kept by
        reference to count the step kernel's spawns and resets."""
        plain, plain_s = tracer.timed(self._calls)
        kept = []
        fast_step = self.fastlib.fast_step

        def counted(*args, **kw):
            state, ts = fast_step(*args, **kw)
            kept.append((ts.valid, ts.done))
            return state, ts

        self.fastlib.fast_step = counted
        try:
            with tracer as t:
                traced = self._calls()
        finally:
            self.fastlib.fast_step = fast_step
        moves = int(sum(r.lengths.sum() for r in traced))
        batch_steps = sum(r.batch_steps for r in traced)
        return t.summary(dict(
            plain_s=plain_s, plain_pace=sum(r.batch_steps for r in plain),
            pace=batch_steps, work=moves, moves=moves,
            lane_steps=batch_steps * self.traffic["batch"],
            spawns=int(sum(v.sum() for v, _ in kept)),
            resets=int(sum(d.sum() for _, d in kept)), emit_legal=True,
            forward_flops=flops.dqn_forward(self.cfg)))

    def release(self):
        self.policy = None

    def _segments(self):
        """Each call's recorded steps and words."""
        ends = [first for _, first in self.calls[1:]] + [
            (len(self.steps), len(self.bits.calls))]
        for (res, (s0, w0)), (s1, w1) in zip(self.calls, ends):
            yield res, self.steps[s0:s1], self.bits.calls[w0:w1]

    def check(self, quant=None):
        lim, dev, b = self.own["limits"], self.device, self.traffic["batch"]
        step_bad = result_bad = 0
        positions = []  # (board, legal, action) of moves, a block a call
        for res, steps, words in self._segments():
            boards = torch.stack([s[0].reshape(b, 16) for s in steps]
                                 ).to(torch.int64)  # (T, B, 16)
            legal = torch.stack([s[1] for s in steps])
            actions = torch.stack([s[2] for s in steps]).to(torch.int64)
            w = torch.stack(words[1:]).to(torch.int64)  # (T, 8, B)
            fresh = game.word_fresh(*words[0].to(torch.int64)[4:8])
            step_bad += int((boards[0] != fresh).any(1).sum())
            n, t_len = b * len(steps), len(steps)
            flat_b, flat_a = boards.reshape(n, 16), actions.reshape(n)
            flat_w = w.permute(1, 0, 2).reshape(8, n)
            outs = {k: [] for k in ("final", "score", "done", "max_exp")}
            legal_bad = 0
            for i in range(0, n, BLOCK):
                o = game.word_step(flat_b[i:i + BLOCK], flat_a[i:i + BLOCK],
                                   flat_w[:, i:i + BLOCK])
                for k in outs:
                    outs[k].append(o[k])
                legal_bad += int((game.legal(flat_b[i:i + BLOCK])
                                  != legal.reshape(n, 4)[i:i + BLOCK])
                                 .any(1).sum())
            o = {k: torch.cat(v).reshape(t_len, b, *v[0].shape[1:])
                 for k, v in outs.items()}
            step_bad += legal_bad + int(
                (o["final"][:-1] != boards[1:]).any(2).sum())
            # Each lane's first game: score, largest tile and length.
            done = o["done"]
            ended = done.any(0)
            first = torch.where(ended, done.to(torch.int8).argmax(0),
                                t_len - 1)
            before = torch.arange(t_len, device=dev)[:, None] <= first
            score = (o["score"] * before).sum(0)
            lanes = torch.arange(b, device=dev)
            tile = torch.where(ended, game.values(o["max_exp"][first, lanes]),
                               game.values(boards[-1].max(1).values))
            length = torch.where(ended, first + 1, t_len)
            for got, want in ((res.scores, score), (res.max_tiles, tile),
                              (res.lengths, length)):
                result_bad += int((torch.as_tensor(got, device=dev)
                                   != want).sum())
            live = before.reshape(n)
            positions.append((flat_b[live], legal.reshape(n, 4)[live],
                              flat_a[live]))
        pb, pl, pa = (torch.cat(x) for x in zip(*positions))
        g = torch.Generator(device="cpu").manual_seed(
            core.derive(self.seed, 5))
        pick = torch.randperm(pb.shape[0], generator=g)[
            :self.own["q_positions"]].to(dev)
        pb, pl, pa = pb[pick], pl[pick], pa[pick]
        weights = core.weights(self.ref, self.cfg, dev)
        q = self.ref.q_values(self.cfg, weights, pb)
        allowed = judge.allowed_moves(pl, None)
        if quant is not None:
            pa = judge.first_choice(
                self.ref.q_values(self.cfg, weights, pb, quant), allowed)
        gaps = judge.q_gaps(q, allowed, pa)
        finite = gaps[torch.isfinite(gaps)]
        return [("step_mismatch", step_bad, lim["step_mismatch"]),
                ("result_mismatch", result_bad, lim["result_mismatch"]),
                ("action_mismatch", int(torch.isinf(gaps).sum()),
                 lim["action_mismatch"]),
                ("q_gap", float(finite.max()) if finite.numel() else 0.0,
                 lim["q_gap"])]
