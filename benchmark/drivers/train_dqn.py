"""Traffic ``train_dqn``: the ``train dqn`` loop, the port's
``training/dqn.py::train_chunk`` called back to back on one loop state.

Set-up builds the loop state from the configuration (``init_loop_state``),
gives it the benchmark's weights and its env and actor sources (the port's
own generator classes, seeded by the benchmark), and runs chunks until
episodes have ended and a chunk with learner updates has completed. The
window then runs whole chunks until ``--seconds`` have passed: the rate is
every update over the whole window.

The comparison follows set-up from the start to the first ``updates``
learner updates. The reference plays every env step again from the
recorded env words on the port's actions, and judges each action: an
exploring lane's against the actor's random pick, a greedy lane's by the
gap of its Q-value below the best allowed one under the float32 network.
It keeps its own dedup caches and replay memory, samples its own batches
from the recorded uniforms, and trains its own float32 learner on them with
the recorded dropout uniforms; it compares the losses, each sample's TD
error ``|target - Q(s, a)|`` of the first update (from the learner's own
forwards, before Adam has moved a weight), the first gradient (read from
Adam's first moment after one update) and the parameters' change after
the last update, each by the worst leaf.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import core, judge, port
from benchmark.counts import flops
from benchmark.reference import game

SPANS = ("actor", "env_step", "replay_add", "learner", "bench.train_chunk")
BETA1 = 0.9


class _Draws(core.Recording):
    """The actor's draw source, recording ``select``'s draws and, for each
    replay sample, the generator's state before it (the uniforms it draws
    next are the sample's)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.samples = []

    def select(self, b):
        return self(b)

    def __call__(self, b):
        out = self.inner.select(b)
        if self.on:
            self.calls.append(out)
        return out

    def indices(self, buffer, batch, alpha):
        if self.on:
            self.samples.append(self.inner.generator.get_state())
        return self.inner.indices(buffer, batch, alpha)


class Driver:
    spans = SPANS
    faults = ("half_batch",)  # planted in the reference in its place

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.own = cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from tpu2048_torch.agents import dqn as dqnlib
        from tpu2048_torch.env import fast as fastlib
        from tpu2048_torch.training import dqn as dtrain

        tr = self.traffic
        self.config = dtrain.DQNTrainConfig(
            agent=port.dqn_agent_config(self.cfg, tr),
            num_envs=tr["num_envs"], engine="fast",
            updates_per_episode=tr["updates_per_episode"],
            max_updates_per_step=tr["max_updates_per_step"],
            train_batch=tr["train_batch"],
            steps_per_chunk=tr["steps_per_chunk"],
            seed=core.derive(self.seed, 3))
        st = dtrain.init_loop_state(self.config, self.device)
        weights = core.weights(self.ref, self.cfg, self.device)
        port.load_weights(st.agent.model, weights)
        port.load_weights(st.agent.target, weights)
        self.bits = core.Recording(fastlib.GeneratorBits(
            core.derive(self.seed, 1), self.device))
        self.draws = _Draws(dqnlib.GeneratorDraws(
            core.derive(self.seed, 2), self.device))
        st.bits, st.draws = self.bits, self.draws
        st.env_state = fastlib.fast_reset(self.bits, tr["num_envs"],
                                          dtrain.fast_config(self.config))
        self.steps, self.updates = [], []
        self.first_grad, self.change = None, None
        self._w0 = weights
        self._record(dqnlib, st)
        try:
            for _ in range(self.own["setup_max_chunks"]):
                dtrain.train_chunk(self.config, st)
                if st.agent.train_steps > 0:
                    break
            else:
                raise RuntimeError("no learner update in set-up")
        finally:
            dqnlib.select_actions, dqnlib.train_step = self._originals
        if len(self.updates) < self.own["updates"]:
            raise RuntimeError("set-up's first chunk with updates made "
                               f"{len(self.updates)} updates")
        st.bits, st.draws = self.bits.inner, self.draws.inner
        self.state = st
        self.dtrain = dtrain
        self._w0 = None

    def _record(self, dqnlib, st):
        """Wrap the actor's choice and the learner's update for set-up: each
        vector step's inputs and actions, and each of the first updates'
        batch, loss, dropout generator state and the norms the comparison
        reads."""
        select, train = dqnlib.select_actions, dqnlib.train_step
        self._originals = (select, train)
        n = self.own["updates"]

        def recording_select(model, boards, legal, restrict, eps, draws):
            actions = select(model, boards, legal, restrict, eps, draws)
            if self.bits.on:
                self.steps.append((boards, legal, restrict, eps, draws,
                                   actions))
            return actions

        def recording_train(config, state, batch, grad_reduce=None):
            if len(self.updates) >= n:
                return train(config, state, batch, grad_reduce)
            gen = state.generator.get_state()
            loss, td = train(config, state, batch, grad_reduce)
            self.updates.append((batch, loss.detach().clone(), td.clone(),
                                 gen))
            params = dict(state.model.named_parameters())
            if len(self.updates) == 1:
                opt = state.optimizer.state
                self.first_grad = judge.norms(
                    {k: opt.get(p, {}).get("exp_avg", torch.zeros_like(p))
                     / (1 - BETA1) for k, p in params.items()})
            if len(self.updates) == n:
                self.change = judge.norms(
                    {k: p.detach() - self._w0[k] for k, p in params.items()})
                self._w0 = None
                self.bits.on = self.draws.on = False
            return loss, td

        dqnlib.select_actions = recording_select
        dqnlib.train_step = recording_train

    # -- the window -----------------------------------------------------
    def run(self, seconds: float):
        st, u0 = self.state, self.state.agent.train_steps
        steps0 = st.env_steps
        self.debts = []
        t0 = time.perf_counter()
        while True:
            self.dtrain.train_chunk(self.config, st)
            self.debts.append(st.update_debt)
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.device)
        dt = time.perf_counter() - t0
        updates = st.agent.train_steps - u0
        self.window = dict(chunks=len(self.debts), updates=updates,
                           vector_steps=(st.env_steps - steps0)
                           // self.config.num_envs, debt=self.debts)
        return {"updates_per_s": updates / dt}, updates

    def _vector_steps(self):
        """Vector steps, one a call, to the trace's bound; returns the
        steps and the updates they made."""
        st, u0 = self.state, self.state.agent.train_steps
        one = dataclasses.replace(self.config, steps_per_chunk=1)
        bound = self.own["trace"]
        n = 0
        while n < bound["min_vector_steps"] or (
                st.agent.train_steps - u0 < bound["min_updates"]
                and n < bound["max_vector_steps"]):
            with record_function("bench.train_chunk"):
                self.dtrain.train_chunk(one, st)
            n += 1
        return n, st.agent.train_steps - u0

    def run_traced(self, tracer):
        (_, plain), plain_s = tracer.timed(self._vector_steps)
        with tracer as t:
            n, updates = self._vector_steps()
        tr = self.traffic
        return t.summary(dict(
            plain_s=plain_s, plain_pace=plain, pace=updates,
            work=updates, updates=updates, vector_steps=n,
            envs=tr["num_envs"], forward_flops=flops.dqn_forward(self.cfg),
            update_flops=flops.dqn_update(self.cfg, tr["train_batch"])))

    def release(self):
        self.state = None

    # -- the comparison -------------------------------------------------
    def check(self, quant=None):
        """The numbers compared, each with its limit. With ``quant`` the
        control's (the reference in that precision in the port's place) or,
        with ``half_batch``, the numbers of that fault planted in it."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        b = tr["num_envs"]
        words = [w.to(torch.int64) for w in self.bits.calls]
        board = game.word_fresh(*words[0][4:8])
        cap = cfg["memory_size"]
        mem = dict(board=torch.zeros((cap, 16), dtype=torch.int64,
                                     device=dev),
                   action=torch.zeros(cap, dtype=torch.int64, device=dev),
                   reward=torch.zeros(cap, device=dev),
                   done=torch.zeros(cap, dtype=torch.bool, device=dev))
        mem["next_board"] = torch.zeros_like(mem["board"])
        ptr = size = debt = 0
        cache_s = torch.zeros((b, 2, 16), dtype=torch.int64, device=dev)
        cache_n = torch.zeros_like(cache_s)
        saved = torch.zeros(b, dtype=torch.int64, device=dev)
        last_saved = torch.ones(b, dtype=torch.bool, device=dev)
        env_bad = actor_bad = 0
        greedy = []
        first_update_step = None
        f32 = np.float32
        for t, (pb, plegal, prestrict, peps, draws, pact) in enumerate(
                self.steps):
            pb = pb.reshape(b, 16).to(torch.int64)
            env_bad += int((pb != board).any(1).sum())
            legal = game.legal(board)
            env_bad += int((plegal != legal).any(1).sum())
            eps = float(max(f32(cfg["epsilon_min"]), f32(cfg["epsilon"])
                            * np.power(f32(cfg["epsilon_decay"]),
                                       f32(b * t))))
            actor_bad += int(eps != peps)
            restrict = ~last_saved
            actor_bad += int((prestrict != restrict).sum())
            explore_u, rand_any, legal_u = draws
            n_legal = legal.sum(1)
            pick = torch.floor(legal_u * n_legal.clamp_min(1).to(
                torch.float32)).to(torch.int64)
            nth = (legal.cumsum(1) == pick[:, None] + 1) & legal
            rand_legal = torch.where(legal.any(1), nth.to(torch.int8).argmax(1),
                                     rand_any.to(torch.int64))
            rand = torch.where(restrict, rand_legal, rand_any.to(torch.int64))
            act = pact.to(torch.int64)
            explore = explore_u < eps
            actor_bad += int((explore & (act != rand)).sum())
            g = ~explore
            greedy.append((board[g], legal[g], restrict[g], act[g]))
            out = game.word_step(board, act, words[t + 1])
            done = out["done"]
            reward = torch.where(~out["moved"] & ~done, -10.0,
                                 out["score"].to(torch.float32))
            top, second = game.values(out["max_exp"]), game.values(
                out["second_exp"])
            bonus = torch.where(top >= 2048, 100.0, torch.where(
                (top >= 1024) & (second >= 1024), 50.0, 0.0))
            reward = reward + torch.where(done, bonus, 0.0)
            new = out["new"]
            same = ((board == cache_s[:, 1]).all(1)
                    & (new == cache_n[:, 1]).all(1))
            save = done | ~same | (saved < 3)
            keep = save[:, None, None]
            cache_s = torch.where(keep, torch.stack([board, cache_s[:, 0]], 1),
                                  cache_s)
            cache_n = torch.where(keep, torch.stack([new, cache_n[:, 0]], 1),
                                  cache_n)
            saved = saved + save.to(torch.int64)
            last_saved = save
            lanes = torch.nonzero(save)[:, 0]
            at = (ptr + torch.arange(lanes.numel(), device=dev)) % cap
            for k, v in (("board", board), ("action", act), ("reward", reward),
                         ("done", done), ("next_board", new)):
                mem[k][at] = v[lanes]
            ptr = (ptr + lanes.numel()) % cap
            size = min(size + lanes.numel(), cap)
            debt += int(done.sum()) * tr["updates_per_episode"]
            if size >= tr["train_batch"] and eps < 1.0:
                if debt and first_update_step is None:
                    first_update_step = t
                debt -= min(debt, tr["max_updates_per_step"])
            else:
                debt = 0
            board = out["final"]
        replay_bad = int(first_update_step != len(self.steps) - 1)

        # Each greedy choice against the float32 network's best.
        gb, gl, gr, ga = (torch.cat(x) for x in zip(*greedy))
        weights = core.weights(self.ref, cfg, dev)
        q = self.ref.q_values(cfg, weights, gb)
        allowed = judge.allowed_moves(gl, gr)
        if quant == cfg["control"]:
            ga = judge.first_choice(self.ref.q_values(cfg, weights, gb, quant),
                                    allowed)
        gaps = judge.q_gaps(q, allowed, ga)
        actor_bad += int(torch.isinf(gaps).sum())
        finite = gaps[torch.isfinite(gaps)]
        q_gap = float(finite.max()) if finite.numel() else 0.0

        # The first updates: the reference's own batches and learner.
        learner = self.ref.Learner(cfg, weights)
        control = self.ref.Learner(cfg, weights, quant) if quant else None
        loss_gap, td_gap, ref_first, cand_first = 0.0, None, None, None
        for k, (pbatch, ploss, ptd, gen) in enumerate(self.updates):
            u = torch.rand(tr["train_batch"], dtype=torch.float64,
                           generator=_gen(self.draws.samples[k], dev),
                           device=dev)
            idx = torch.minimum((u * max(size, 1)).to(torch.int64),
                                torch.tensor(max(size, 1) - 1, device=dev))
            batch = {k2: v[idx] for k2, v in mem.items()}
            replay_bad += int(sum(
                (pbatch[k2].reshape(len(idx), -1).to(v.dtype)
                 != v.reshape(len(idx), -1)).any(1)
                for k2, v in batch.items()).sum())
            drop = torch.rand((tr["train_batch"], cfg["hidden"]),
                              generator=_gen(gen, dev), device=dev)
            loss, grads, td = learner.update(batch, drop)
            if control is not None:
                cand_loss, cand_grads, cand_td = control.update(batch, drop)
            else:
                cand_loss, cand_grads, cand_td = float(ploss), None, ptd
            loss_gap = max(loss_gap, abs(cand_loss - loss) / abs(loss))
            if k == 0:
                n = len(cand_td)
                td_gap = float((cand_td.to(td.dtype) - td[:n]).abs().max())
                ref_first = judge.norms(grads)
                cand_first = (judge.norms(cand_grads) if cand_grads
                              else self.first_grad)
        ref_change = judge.norms({k: learner.w[k] - weights[k]
                                  for k in weights})
        cand_change = (judge.norms({k: control.w[k] - weights[k]
                                    for k in weights})
                       if control else self.change)
        lim = self.own["limits"]
        grad_gaps = judge.leaf_gaps(cand_first, ref_first, ref_first)
        if quant is None:
            self.window = dict(getattr(self, "window", {}), left_out=sorted(
                set(ref_first) - set(grad_gaps)))
        return [
            ("env_mismatch", env_bad, lim["env_mismatch"]),
            ("actor_mismatch", actor_bad, lim["actor_mismatch"]),
            ("replay_mismatch", replay_bad, lim["replay_mismatch"]),
            ("actor_q_gap", q_gap, lim["actor_q_gap"]),
            ("loss_gap", loss_gap, lim["loss_gap"]),
            ("td_gap", td_gap, lim["td_gap"]),
            ("grad_norm_gap", judge.worst(grad_gaps), lim["grad_norm_gap"]),
            ("update_norm_gap", judge.worst(judge.leaf_gaps(
                cand_change, ref_change, ref_first)), lim["update_norm_gap"]),
        ]


def _gen(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g
