"""Traffic ``play``: model play, the reference GUI's third mode. One
``eval/demo.py::GameSession`` in model mode on the card, ``step_auto``
called back to back: a closed loop with one client at batch 1 on the
classic env. At game over a new session starts, seeded from the run's
seed.

A move's latency is the host's time of its ``step_auto`` call, which ends
with the session's host read of the new board. The p95 is over every move
of the window; a new session's start at game over is in the window's time
and in no move's latency.

The session's spawn source is wrapped after the session starts, so that
the uniforms of each spawn are kept by reference; a session's first board
comes from the first four uniforms of its seed's generator. Once the
window has closed the reference checks every move: the board after it
against the reference's move and spawn from the board before on the
port's action, whether the game goes on, and each greedy choice by the gap
of its Q-value below the best legal one under the float32 network.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import core, judge, port
from benchmark.counts import flops
from benchmark.reference import game

SPANS = ("bench.step_auto", "bench.new_session")


class _Session:
    """A started session and what it recorded."""

    def __init__(self, demo, policy, seed, device):
        self.seed = seed
        self.game = demo.GameSession(mode="model", policy=policy, seed=seed,
                                     device=device)
        self.first = self.game.state.board
        self.moves = []  # (board before, action, spawn uniforms)
        source = self.game.source
        draw = source._uniform
        self.drawn = []

        def recorded(shape):
            u = draw(shape)
            self.drawn.append(u)
            return u

        source._uniform = recorded

    def step(self):
        before = self.game.state.board
        action = self.game.step_auto()
        self.moves.append((before, action))
        return self.game.alive


class Driver:
    spans = SPANS

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    def setup(self):
        from tpu2048_torch.eval import demo
        from tpu2048_torch.eval import evaluate as ev

        self.demo = demo
        weights = core.weights(self.ref, self.cfg, self.device)
        self.policy = ev.greedy_dqn_policy(
            port.dqn_model(self.cfg, weights, self.device))
        self.sessions = []
        warm = self._new()
        for _ in range(self.traffic["warm_moves"]):
            if not warm.step():
                warm = self._new()
        self.sessions, self.current = [], None

    def _new(self):
        s = _Session(self.demo, self.policy,
                     core.derive(self.seed, 10, len(self.sessions)),
                     self.device)
        self.sessions.append(s)
        return s

    def _loop(self, done, span=False):
        """Moves until ``done(moves)``, on from the session the last loop
        left; returns each move's latency."""
        lat = []
        s = self.current or self._new()
        while not done(len(lat)):
            t0 = time.perf_counter()
            if span:
                with record_function("bench.step_auto"):
                    alive = s.step()
            else:
                alive = s.step()
            lat.append(time.perf_counter() - t0)
            if not alive:
                if span:
                    with record_function("bench.new_session"):
                        s = self._new()
                else:
                    s = self._new()
        self.current = s
        return lat

    def run(self, seconds: float):
        t0 = time.perf_counter()
        lat = self._loop(lambda n: time.perf_counter() - t0 >= seconds)
        return {"move_ms_p95": float(np.percentile(lat, 95)) * 1e3}, len(lat)

    def run_traced(self, tracer):
        """``trace.moves`` moves timed without the profiler, then as many
        under it."""
        n = self.own["trace"]["moves"]
        _, plain_s = tracer.timed(lambda: self._loop(lambda m: m >= n, True))
        with tracer as t:
            self._loop(lambda m: m >= n, span=True)
        return t.summary(dict(plain_s=plain_s, plain_pace=n, pace=n,
                              work=n, moves=n,
                              forward_flops=flops.dqn_forward(self.cfg)))

    def release(self):
        self.policy = None

    def check(self, quant=None):
        lim, dev = self.own["limits"], self.device
        step_bad = 0
        boards, legal, actions = [], [], []
        for i, s in enumerate(self.sessions):
            g = torch.Generator(device=dev).manual_seed(s.seed)
            fresh = game.uniform_fresh(torch.rand((4, 1), generator=g,
                                                  device=dev))
            before = [m[0].reshape(1, 16).to(torch.int64) for m in s.moves]
            end = (self.current.game.state.board
                   if i == len(self.sessions) - 1 else None)
            after = before[1:] + ([end.reshape(1, 16).to(torch.int64)]
                                  if end is not None else [])
            step_bad += int((s.first.reshape(1, 16).to(torch.int64)
                             != fresh).any())
            if not s.moves:
                continue
            b = torch.cat(before)
            a = torch.tensor([m[1] for m in s.moves], device=dev)
            u = torch.cat(s.drawn, 1)  # (2, moves)
            new, _, _, over = game.uniform_step(b, a, u)
            k = len(after)
            step_bad += int((new[:k] != torch.cat(after)).any(1).sum())
            # A session ends where its last move ends the game, and only
            # there; the window's last session is still live.
            over_at = torch.nonzero(over)[:, 0].tolist()
            ended = i < len(self.sessions) - 1
            step_bad += int(over_at != ([len(s.moves) - 1] if ended else []))
            boards.append(b)
            legal.append(game.legal(b))
            actions.append(a)
        pb, pl, pa = torch.cat(boards), torch.cat(legal), torch.cat(actions)
        weights = core.weights(self.ref, self.cfg, dev)
        q = self.ref.q_values(self.cfg, weights, pb)
        allowed = judge.allowed_moves(pl, None)
        if quant is not None:
            pa = judge.first_choice(
                self.ref.q_values(self.cfg, weights, pb, quant), allowed)
        gaps = judge.q_gaps(q, allowed, pa)
        finite = gaps[torch.isfinite(gaps)]
        return [("step_mismatch", step_bad, lim["step_mismatch"]),
                ("action_mismatch", int(torch.isinf(gaps).sum()),
                 lim["action_mismatch"]),
                ("q_gap", float(finite.max()) if finite.numel() else 0.0,
                 lim["q_gap"])]
