"""Traffic ``train_dqn_dp``: the ``train dqn --data-parallel R
--replay-shards R`` loop, the port's ``training/dqn.py::train_chunk`` on R
ranks of a process group, one card and one replay shard a rank (NCCL on
the cards, gloo on the CPU), every learner update's gradients averaged
over the ranks by one all-reduce.

This process is rank 0. Set-up spawns ranks 1 .. R-1 as
``parallel/testkit.py::spawn_ranks`` spawns them (new processes, a free
local port, ``parallel/mesh.py::distributed_init``), and every rank builds
its loop state from the configuration (``init_loop_state``: the rank's
envs, replay shard and learner batch), gives its networks the benchmark's
weights, and runs chunks until a chunk with learner updates has completed.
From then on the other ranks wait for rank 0's word, broadcast before
each piece of work: a chunk, the traced part's vector steps, or the end.
The window runs whole chunks on every rank until ``--seconds`` have passed
on rank 0; an update is synchronous over the ranks, so the rate is rank
0's updates over the window. Under ``--trace 1`` only rank 0 is profiled.

The comparison re-derives rank 0's first ``updates`` learner updates: each
rank records the batches it sampled and its dropout generator's state
before each, and rank 0 its losses, TD errors, first gradient and the
parameters' change. The reference trains its float32 learner on the
ranks' batches joined in rank order (the job's batch) with each rank's
dropout draws, and compares, as ``train_dqn`` does: the losses, rank 0's
TD errors of the first update, the first gradient and the change after the
last update, each by the worst leaf. The fault ``no_allreduce`` trains
the reference on rank 0's batch alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.profiler import record_function

from benchmark import core, judge, port

SPANS = ("actor", "env_step", "replay_add", "learner", "learner.allreduce",
         "bench.train_chunk")
BETA1 = 0.9
CHUNK, STEPS, GATHER = 1, 2, 3  # rank 0's words to the other ranks
TIMEOUT_S = 300.0


class _Rank:
    """One rank's part: its loop state, its record of the first updates,
    and the work rank 0 asks for."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.own = cell.config, cell.traffic, cell.own
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")

    def setup(self):
        from tpu2048_torch.agents import dqn as dqnlib
        from tpu2048_torch.training import dqn as dtrain

        tr = self.traffic
        r = tr["ranks"]
        self.dtrain, self.dqnlib = dtrain, dqnlib
        self.config = dtrain.DQNTrainConfig(
            agent=port.dqn_agent_config(
                self.cfg, dict(train_batch=r * tr["batch_per_rank"])),
            num_envs=r * tr["envs_per_rank"], engine="fast",
            updates_per_episode=tr["updates_per_episode"],
            max_updates_per_step=tr["max_updates_per_step"],
            train_batch=r * tr["batch_per_rank"],
            steps_per_chunk=tr["steps_per_chunk"], replay_shards=r,
            seed=core.derive(self.seed, 3))
        st = dtrain.init_loop_state(self.config, self.device)
        weights = core.weights(self.ref, self.cfg, self.device)
        port.load_weights(st.agent.model, weights)
        port.load_weights(st.agent.target, weights)
        self.updates, self.first_grad, self.change = [], None, None
        train = dqnlib.train_step
        n = self.own["updates"]

        def recording(config, state, batch, grad_reduce=None):
            if len(self.updates) >= n:
                return train(config, state, batch, grad_reduce)
            gen = state.generator.get_state()
            loss, td = train(config, state, batch, grad_reduce)
            self.updates.append(({k: v.cpu() for k, v in batch.items()},
                                 gen, float(loss), td.cpu()))
            params = dict(state.model.named_parameters())
            if len(self.updates) == 1:
                opt = state.optimizer.state
                self.first_grad = judge.norms(
                    {k: opt[p]["exp_avg"] / (1 - BETA1)
                     for k, p in params.items()})
            if len(self.updates) == n:
                self.change = judge.norms(
                    {k: p.detach() - weights[k] for k, p in params.items()})
            return loss, td

        dqnlib.train_step = recording
        try:
            for _ in range(self.own["setup_max_chunks"]):
                dtrain.train_chunk(self.config, st)
                if st.agent.train_steps > 0:
                    break
            else:
                raise RuntimeError("no learner update in set-up")
        finally:
            dqnlib.train_step = train
        if len(self.updates) < n:
            raise RuntimeError(f"set-up's first chunk with updates made "
                               f"{len(self.updates)} updates")
        self.state = st

    def word(self, value: int = 0) -> int:
        """Rank 0's word, broadcast to every rank."""
        t = torch.tensor([value], device=self.device)
        dist.broadcast(t, 0)
        return int(t.item())

    def chunk(self):
        self.dtrain.train_chunk(self.config, self.state)

    def vector_steps(self):
        """Vector steps, one a call, to the trace's bound (the same on every
        rank: the updates are counted alike); returns the steps and the
        updates they made."""
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

    def gather(self):
        """Every rank's record of its first updates, on every rank."""
        self.state = None
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, [(b, g) for b, g, _, _ in self.updates])
        return out


def rank_main(root: str, name: str, seed: int, rank: int, world: int,
              port_: int, device_type: str) -> None:
    """Rank ``rank`` > 0: set up, then do rank 0's work until its end."""
    from tpu2048_torch.parallel import mesh

    torch.set_num_threads(1)
    device = mesh.distributed_init(f"127.0.0.1:{port_}", world, rank,
                                   device=device_type, timeout_s=TIMEOUT_S)
    try:
        r = _Rank(core.Cell(name, Path(root)), seed, device)
        r.setup()
        while True:
            word = r.word()
            if word == CHUNK:
                r.chunk()
            elif word == STEPS:
                r.vector_steps()
            else:
                r.gather()
                break
    finally:
        mesh.destroy()


class Driver:
    spans = SPANS
    faults = ("no_allreduce",)  # planted in the reference in its place

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.own = cell.own

    def setup(self):
        from tpu2048_torch.parallel import mesh, testkit

        world = self.cell.traffic["ranks"]
        port_ = testkit.free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        entry = importlib.import_module("benchmark.drivers.train_dqn_dp")
        root = str(self.cell.bench.parent)
        self.procs = [ctx.Process(target=entry.rank_main, args=(
            root, self.cell.name, self.seed, r, world, port_,
            self.device.type)) for r in range(1, world)]
        for p in self.procs:
            p.start()
        self.mesh = mesh
        device = mesh.distributed_init(f"127.0.0.1:{port_}", world, 0,
                                       device=self.device.type,
                                       timeout_s=TIMEOUT_S)
        self.rank = _Rank(self.cell, self.seed, device)
        self.rank.setup()

    def run(self, seconds: float):
        r = self.rank
        u0 = r.state.agent.train_steps
        chunks = 0
        t0 = time.perf_counter()
        while True:
            r.word(CHUNK)
            r.chunk()
            chunks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(r.device)
        dt = time.perf_counter() - t0
        updates = r.state.agent.train_steps - u0
        self.window = dict(chunks=chunks, updates=updates,
                           ranks=self.cell.traffic["ranks"])
        return {"updates_per_s": updates / dt}, updates

    def _steps(self):
        self.rank.word(STEPS)
        return self.rank.vector_steps()

    def run_traced(self, tracer):
        (_, plain), plain_s = tracer.timed(self._steps)
        with tracer as t:
            n, updates = self._steps()
        return t.summary(dict(
            plain_s=plain_s, plain_pace=plain, pace=updates, work=updates,
            updates=updates, vector_steps=n,
            ranks=self.cell.traffic["ranks"]))

    def release(self):
        self.rank.word(GATHER)
        self.gathered = self.rank.gather()
        self.mesh.destroy()
        for p in self.procs:
            p.join(TIMEOUT_S)
        bad = [(i + 1, p.exitcode) for i, p in enumerate(self.procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")

    def check(self, quant=None):
        """The numbers compared, each with its limit. With ``quant`` the
        control's (the reference in that precision in the program's place)
        or, with ``no_allreduce``, the numbers of the reference trained on
        rank 0's batch alone."""
        r, dev = self.rank, self.device
        cfg = r.cfg
        hidden = cfg["hidden"]
        weights = core.weights(r.ref, cfg, dev)
        learner = r.ref.Learner(cfg, weights)
        control = None
        if quant is not None:
            control = r.ref.Learner(
                cfg, weights, None if quant == "no_allreduce" else quant)
        loss_gap, td_gap = 0.0, None
        ref_first = cand_first = None
        for k, (_, _, ploss, ptd) in enumerate(r.updates):
            parts = [rank_updates[k] for rank_updates in self.gathered]
            batch = {key: torch.cat([b[key] for b, _ in parts]).to(dev)
                     for key in parts[0][0]}
            drop = torch.cat([torch.rand((len(b["action"]), hidden),
                                         generator=_gen(g, dev), device=dev)
                              for b, g in parts])
            loss, grads, td = learner.update(_reference_batch(batch), drop)
            if control is not None:
                n0 = len(parts[0][0]["action"])
                cb = _reference_batch(batch)
                if quant == "no_allreduce":
                    cb = {key: v[:n0] for key, v in cb.items()}
                    cdrop = drop[:n0]
                else:
                    cdrop = drop
                cand_loss, cand_grads, cand_td = control.update(cb, cdrop)
            else:
                cand_loss, cand_grads, cand_td = ploss, None, ptd.to(dev)
            loss_gap = max(loss_gap, abs(cand_loss - loss) / abs(loss))
            if k == 0:
                n = len(parts[0][0]["action"])
                td_gap = float((cand_td[:n].to(td.dtype) - td[:n]).abs()
                               .max())
                ref_first = judge.norms(grads)
                cand_first = (judge.norms(cand_grads) if cand_grads
                              else r.first_grad)
        ref_change = judge.norms({k: learner.w[k] - weights[k]
                                  for k in weights})
        cand_change = (judge.norms({k: control.w[k] - weights[k]
                                    for k in weights})
                       if control else r.change)
        lim = self.own["limits"]
        return [
            ("loss_gap", loss_gap, lim["loss_gap"]),
            ("td_gap", td_gap, lim["td_gap"]),
            ("grad_norm_gap", judge.worst(judge.leaf_gaps(
                cand_first, ref_first, ref_first)), lim["grad_norm_gap"]),
            ("update_norm_gap", judge.worst(judge.leaf_gaps(
                cand_change, ref_change, ref_first)), lim["update_norm_gap"]),
        ]


def _reference_batch(batch):
    """A sampled batch of the port in the reference's terms: ``(N, 16)``
    int64 boards, int64 actions, float32 rewards, bool dones."""
    n = len(batch["action"])
    return dict(board=batch["board"].reshape(n, 16).to(torch.int64),
                action=batch["action"].reshape(n).to(torch.int64),
                reward=batch["reward"].reshape(n).to(torch.float32),
                done=batch["done"].reshape(n).to(torch.bool),
                next_board=batch["next_board"].reshape(n, 16)
                .to(torch.int64))


def _gen(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g
