"""Traffic ``train_ntuple``: the ``train ntuple`` loop, the port's
``training/ntuple.py::train_chunk`` called back to back on one network: the
4x6-tuple network learning by TD(0) on afterstates, greedy, every lane a
game of the fast env in simple mode, a finished game reset in its step.

Set-up builds the port's network from the configuration, with zero
weights as TDL2048 starts, and the trainer's state with the port's own
bit source seeded by the benchmark. It then trains the network for the
traffic's ``warm_lane_steps`` lane-steps (the traffic's fill: games reach
late-game tiles, so that the lookup table's touched set is a trained
agent's, not the few MB that fresh weights touch), and runs the check's
``check_steps`` steps one chunk of one step each: before each step it
copies the lookup table and the lanes, and the state of the bit source's
generator. Every one of those steps replays the captured step that the
window replays. The window runs whole chunks until ``--seconds`` have
passed; every lane makes a move each step, so the rate is lanes times
steps over the window.

The comparison follows the check's steps, each teacher-forced from the
program's copy before it: the reference derives the step again from the
copied table and lanes and the words the copied generator state draws, and
compares the five values of every lane (``value_gap``), the greedy actions
where its two best moves lie further apart than ``value_gap``'s limit
(``action_mismatch``; inside that margin the program's action is taken),
every weight either side wrote (``lut_gap``), and the lanes after the
step: boards, scores, dones and the kept afterstates (``env_mismatch``).
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import torch

from benchmark import core
from benchmark.reference import game

SPANS = ("ntuple.step", "ntuple.evaluate", "ntuple.learn", "ntuple.env_step")


class Driver:
    spans = SPANS
    faults = ("iso7", "no_terminal")  # planted in the reference in its place

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    def setup(self):
        from tpu2048_torch.agents import ntuple as agent
        from tpu2048_torch.env import fast as fastlib
        from tpu2048_torch.models.ntuple import NTupleNetwork
        from tpu2048_torch.training import ntuple as ntrain

        cfg, tr = self.cfg, self.traffic
        self.ntrain = ntrain
        self.patterns = [list(p) for p in cfg["patterns"]]
        self.config = ntrain.NTupleTrainConfig(
            agent=agent.NTupleConfig(
                patterns=tuple(map(tuple, self.patterns)),
                alpha=cfg["alpha"]),
            batch_size=tr["lanes"], steps_per_chunk=tr["steps_per_chunk"])
        self.net = NTupleNetwork(self.config.agent.patterns, self.device)
        self.bits = fastlib.GeneratorBits(core.derive(self.seed, 1),
                                          self.device)
        st = ntrain.init_train_state(self.config, self.bits)
        chunks = tr["warm_lane_steps"] // (tr["lanes"] * tr["steps_per_chunk"])
        for _ in range(chunks):
            st = ntrain.train_chunk(self.config, self.net, st, self.bits)
        one = dataclasses.replace(self.config, steps_per_chunk=1)
        self.snaps = []
        for _ in range(tr["check_steps"]):
            snap = self._snapshot(st)
            st = ntrain.train_chunk(one, self.net, st, self.bits)
            snap.update(values=st.values, v_prev=st.v_prev,
                        actions=st.actions)
            self.snaps.append(snap)
        self.after_check = self._snapshot(st)
        self.touched = int(self.net.weights.count_nonzero())
        self.state = st

    def _snapshot(self, st):
        """Copies of the lookup table (in host memory, out of the window's
        device memory) and the lanes, and the bit source's generator state:
        what the next step starts from."""
        return dict(lut=self.net.weights.view(-1).to("cpu", copy=True),
                    gen=self.bits.generator.get_state(),
                    boards=st.env_state.boards.clone(),
                    score=st.env_state.score.clone(),
                    prev_after=st.lanes.prev_after.clone(),
                    prev_valid=st.lanes.prev_valid.clone(),
                    prev_terminal=st.lanes.prev_terminal.clone())

    def run(self, seconds: float):
        st = self.state
        steps = 0
        chunk = self.ntrain.train_chunk
        before = (chunk.eager_steps, chunk.graph_steps)
        t0 = time.perf_counter()
        while True:
            st = self.ntrain.train_chunk(self.config, self.net, st,
                                         self.bits)
            steps += self.config.steps_per_chunk
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.device)
        dt = time.perf_counter() - t0
        self.state = st
        moves = steps * self.config.batch_size
        self.window = dict(steps=steps,
                           eager_steps=chunk.eager_steps - before[0],
                           graph_steps=chunk.graph_steps - before[1],
                           touched_weights=self.touched,
                           weights=self.net.weights.numel())
        return {"env_steps_per_s": moves / dt}, moves

    def _steps(self):
        """One eager step (its spans name the step's parts in the trace),
        then ``trace.steps`` steps of one replay each; returns the legal
        moves each step evaluated and its lanes with a previous
        afterstate, kept on the device."""
        one = dataclasses.replace(self.config, steps_per_chunk=1)
        st = self.ntrain.train_step(self.config, self.net, self.state,
                                    self.bits)
        kept = [(st.values, self.state.lanes.prev_valid)]
        for _ in range(self.own["trace"]["steps"]):
            prev = st.lanes.prev_valid
            st = self.ntrain.train_chunk(one, self.net, st, self.bits)
            kept.append((st.values, prev))
        self.state = st
        return kept

    def run_traced(self, tracer):
        """The bounded part timed without the profiler, then under it. The
        legal moves come from each step's values (-inf where illegal), kept
        by reference."""
        _, plain_s = tracer.timed(self._steps)
        with tracer as t:
            kept = self._steps()
        n = len(kept)
        b, lookups = self.config.batch_size, self.net.lookups
        legal = int(sum(int(torch.isfinite(v).sum()) for v, _ in kept))
        updated = int(sum(int(p.sum()) for _, p in kept))
        return t.summary(dict(
            plain_s=plain_s, plain_pace=n, pace=n, work=n * b, steps=n,
            lanes=b, lane_steps=n * b, lookups=lookups, legal_moves=legal,
            prev_lanes=updated, value_calls=n, update_calls=n))

    def release(self):
        self.state = None
        self.net = None

    def check(self, quant=None):
        """The numbers compared, each with its limit. With ``quant`` the
        control's (the reference in bf16 in the program's place) or those
        of a fault planted in it: ``iso7`` reads 7 of the 8 symmetries,
        ``no_terminal`` updates a game's last afterstate toward the next
        game's value."""
        lim = self.own["limits"]
        margin = lim["value_gap"]
        value_gap = lut_gap = 0.0
        actions_bad = env_bad = 0
        snaps = self.snaps + [self.after_check]
        for snap, nxt in zip(snaps, snaps[1:]):
            lut, lut_next = (s["lut"].to(self.device) for s in (snap, nxt))
            boards = _rows(snap["boards"])
            prev = _rows(snap["prev_after"])
            pv, pt = snap["prev_valid"], snap["prev_terminal"]
            if quant is None:
                got = dict(values=snap["values"], v_prev=snap["v_prev"],
                           action=snap["actions"].long(), lut=lut_next,
                           written=lut_next != lut)
            else:
                w = lut.clone()
                syms, term = 8, pt
                if quant == self.cfg["control"]:
                    w = w.to(torch.bfloat16)
                elif quant == "iso7":
                    syms = 7
                elif quant == "no_terminal":
                    term = torch.zeros_like(pt)
                out = self.ref.td_step(w, self.patterns, boards, prev, pv,
                                       term, self.cfg["alpha"], syms=syms)
                got = dict(values=out["values"].float(),
                           v_prev=out["v_prev"].float(),
                           action=out["action"], lut=w.float(),
                           written=out["written"])
            # The step again on the program's actions; its greedy choice
            # judges them.
            want_w = lut
            want = self.ref.td_step(want_w, self.patterns, boards, prev, pv,
                                    pt, self.cfg["alpha"],
                                    action=got["action"])
            q = torch.where(want["legal"], want["rewards"].float()
                            + want["values"], -torch.inf)
            top = q.topk(2, dim=0).values
            clear = (top[0] - top[1]) / top[0].abs().clamp_min(1) > margin
            actions_bad += int((clear & (got["action"] != want["greedy"]))
                               .sum())
            value_gap = max(value_gap, _gap(got["values"], want["values"]),
                            _gap(got["v_prev"], want["v_prev"]))
            written = got["written"] | want["written"]
            lut_gap = max(lut_gap, _gap(got["lut"][written],
                                        want_w[written]))
            if quant is None:
                env_bad += self._env_mismatch(snap, nxt, boards, want)
        return [("value_gap", value_gap, lim["value_gap"]),
                ("action_mismatch", actions_bad, lim["action_mismatch"]),
                ("lut_gap", lut_gap, lim["lut_gap"]),
                ("env_mismatch", env_bad, lim["env_mismatch"])]

    def _env_mismatch(self, snap, nxt, boards, want):
        """Lanes whose board, score, done or kept afterstate after the step
        differ from the reference's step on the words of the copied
        generator state."""
        g = torch.Generator(device=self.device)
        g.set_state(snap["gen"])
        b = boards.shape[0]
        words = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                              generator=g, device=self.device)
        out = game.word_step(boards, want["action"], words.to(torch.int64))
        score = torch.where(out["done"], 0, snap["score"].to(torch.int64)
                            + out["score"])
        bad = ((_rows(nxt["boards"]) != out["final"]).any(1)
               | (nxt["score"].to(torch.int64) != score)
               | (nxt["prev_terminal"] != out["done"])
               | (_rows(nxt["prev_after"]) != want["chosen"]).any(1)
               | ~nxt["prev_valid"])
        return int(bad.sum())


def _rows(cell_major: torch.Tensor) -> torch.Tensor:
    """``(16, B)`` int8 boards as ``(B, 16)`` int64."""
    return cell_major.T.to(torch.int64)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want| / max(1, |want|)``; two equal infinities
    are no gap, any other infinity or NaN an infinite one."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    same_inf = torch.isinf(want) & (got == want)
    diff = torch.where(same_inf, 0.0, (got - want).abs()
                       / want.abs().clamp_min(1))
    diff = torch.where(torch.isnan(diff), torch.inf, diff)
    return float(diff.max()) if diff.numel() else 0.0
