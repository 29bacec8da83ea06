"""Data parallel: the port's shards and ranks against JAX and against one
process.

* ``train_chunk`` with ``replay_shards=2`` in one process against JAX's
  ``train_chunk`` on the same replayed draws (the harness and tolerances of
  ``tests/test_torch_dqn_train.py``; the sampler replays JAX's per-shard
  split keys).
* The env stepped on lane slices, as each rank steps its own, equals one
  step on all lanes on the same bits (JAX's ``tests/test_sharding.py:62``),
  on both engines.
* Two gloo processes on the CPU, joined as ``--coordinator`` ranks, run
  ``run_chunks``: their digest equals one process with ``replay_shards=2``,
  integers equal, parameters within JAX's ``rtol=2e-4, atol=2e-5`` and the
  loss sum within ``rtol=1e-3`` (``tests/test_sharding.py:126-136``); only
  rank 0's logger writes (``tests/test_multihost.py:56``).
* ``train()`` over two spawned ranks with frequent sync, prune and
  checkpoints equals one process row for row; a sharded resume advances; a
  resume at another world size raises.
* The CLI's multi-device flags run, or exit 2 where they disagree;
  ``dryrun_multichip`` runs on gloo ranks.

Float32, dropout 0, as JAX's equality tests run: a rank's forward sees
B/R boards, and the untrained heads here have no action within 1e-5 of
another in these runs, so the integer paths agree without the tie-free
head of ``tests/test_torch_eval.py``.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_dqn_train import (JaxChain, assert_loops_agree, configs,
                                  start_both)
from test_torch_fast_env import endgame_boards
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.training import dqn as jtrain
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.checkpoint.ckpt import CheckpointManager
from tpu2048_torch.cli.main import main
from tpu2048_torch.env import env as tenv
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.metrics.logging import read_jsonl
from tpu2048_torch.ops import step_kernel as sk
from tpu2048_torch.parallel import mesh, testkit
from tpu2048_torch.replay import sharded as tsh
from tpu2048_torch.training import dqn as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_RTOL, PARAM_ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-3  # tests/test_sharding
CHUNKS = 4
RANK_TIMEOUT_S = 240


class ShardedJaxChain(JaxChain):
    """``JaxChain`` whose sampler replays ``sharded_sample``: the sample
    key split into one key a shard, each shard drawing its part."""

    def __init__(self, chain, shards):
        super().__init__(chain.rng, chain.seed)
        self.shards = shards

    def indices(self, buffer, batch, alpha):
        assert alpha == 0.0
        self.learn, k_sample = jax.random.split(self.learn)
        keys = jax.random.split(k_sample, self.shards)
        per = batch // self.shards
        sizes = tsh.shard_sizes(buffer).tolist()
        return torch.stack([torch.from_numpy(np.array(jax.random.randint(
            keys[s], (per,), 0, max(sizes[s], 1)))) for s in range(
                self.shards)])


def test_train_chunk_with_two_shards_matches_jax():
    jcfg, tcfg = configs(replay_shards=2)
    model, tx, js, ts = start_both(jcfg, tcfg)
    chain = ShardedJaxChain(ts.draws, 2)
    ts.bits, ts.draws = chain.bits, chain
    js, j_eps, _ = jax.jit(
        lambda s: jtrain.train_chunk(jcfg, model, tx, s))(js)
    ts, t_eps = ttrain.train_chunk(tcfg, ts)
    assert t_eps == float(j_eps)
    assert tsh.num_shards(ts.buffer) == 2
    # Each shard against JAX's, the rest of the state once.
    for s in range(2):
        assert_loops_agree(
            dataclasses.replace(ts, buffer=tsh.shard(ts.buffer, s)),
            js.replace(buffer=jax.tree.map(lambda x, s=s: x[s:s + 1],
                                           js.buffer)))
    assert ts.episodes_done >= 8 and ts.agent.train_steps > 40
    # Both shards' rings wrapped.
    assert tsh.shard_sizes(ts.buffer).tolist() == [128, 128]
    assert (ts.agent.train_steps + ts.update_debt
            == tcfg.updates_per_episode * ts.episodes_done)


@pytest.mark.parametrize("engine", ["fast", "lax"])
def test_env_step_on_lane_slices_equals_one_step(engine):
    """Each of R=4 ranks steps its quarter of the lanes with its shard's
    draws; together they equal one step of all lanes."""
    b, r, steps = 32, 4, 12
    rng = np.random.default_rng(3)
    boards = torch.from_numpy(endgame_boards(3, b))
    actions = [torch.from_numpy(rng.integers(0, 4, b).astype(np.int32))
               for _ in range(steps)]
    q = b // r
    if engine == "fast":
        rows = [torch.from_numpy(rng.integers(-2**31, 2**31, (8, b),
                                              dtype=np.int64)).to(torch.int32)
                for _ in range(steps)]
        cfg = tfast.FastEnvConfig(terminal_bonus=True)

        def run(lanes):
            n = lanes.stop - lanes.start
            st = tfast.FastEnvState(
                boards=sk.to_cell_major(boards[lanes]),
                legal=torch.ones(n, 4, dtype=torch.bool),
                score=torch.zeros(n, dtype=torch.int32),
                episode_steps=torch.zeros(n, dtype=torch.int32),
                episode_return=torch.zeros(n))
            bits = tfast.ReplayBits([x[:, lanes].contiguous() for x in rows])
            out = []
            for a in actions:
                st, ts = tfast.fast_step(cfg, st, bits, a[lanes],
                                         need_obs=True, need_legal=True)
                out.append((st.boards.T, st.legal, ts.obs.T, ts.reward,
                            ts.done, ts.episode_return))
            return out
    else:
        cfg = tenv.EnvConfig(reward="simple", terminal_bonus=True)

        def run(lanes):
            shards = range(b)[lanes]
            src = tenv.ShardedSpawns([tenv.GeneratorSpawns(s // q, "cpu")
                                      for s in shards[::q]])
            st = tenv.reset(cfg, src, len(shards))
            st = dataclasses.replace(st, board=boards[lanes])
            out = []
            for a in actions:
                st, ts = tenv.step(cfg, st, a[lanes], src)
                out.append((st.board, ts.obs, ts.reward, ts.done))
            return out

    whole = run(slice(0, b))
    parts = [run(slice(i * q, (i + 1) * q)) for i in range(r)]
    dones = 0
    for t in range(steps):
        for k, want in enumerate(whole[t]):
            got = torch.cat([p[t][k] for p in parts])
            assert torch.equal(got, want), (engine, t, k)
        dones += int(whole[t][-1 if engine == "lax" else 4].sum())
    assert dones > 0  # lanes ended and restarted inside the run


WORKER = """
import json, os, sys, torch
pid, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from tpu2048_torch.parallel.mesh import distributed_init, is_primary_host
distributed_init(f"127.0.0.1:{port}", nproc, pid, device="cpu")
assert is_primary_host() == (pid == 0)
from tpu2048_torch.metrics.logging import JSONLLogger
lg = JSONLLogger(os.path.join(outdir, f"log_{pid}.jsonl"), echo=False)
lg.log({"probe": pid}); lg.close()
from tpu2048_torch.parallel.testkit import CONFIG_KW, run_chunks
digest = run_chunks(nproc, 1, %d, device="cpu", params=True, **CONFIG_KW)
if pid == 0:
    torch.save(digest, os.path.join(outdir, "digest.pt"))
print(f"proc {pid} digest {digest['env_steps']}", flush=True)
""" % CHUNKS


def run_workers(argvs, timeout=RANK_TIMEOUT_S):
    """Start one process an argv and drain their pipes concurrently (a
    worker that fills its pipe mid-collective would stall the others);
    returns their outputs, asserting each exited 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for argv in argvs]
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        outs = [f.result()[0] for f in [
            pool.submit(p.communicate, timeout=timeout) for p in procs]]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


def assert_digests_agree(got, want):
    for k in ("env_steps", "episodes", "train_steps", "eps"):
        assert got[k] == want[k], k
    assert got["param_sum"] == pytest.approx(want["param_sum"],
                                             rel=PARAM_RTOL)
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=LOSS_RTOL)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def test_two_gloo_processes_equal_one_process(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = str(testkit.free_port())
    run_workers([[sys.executable, str(script), str(pid), "2", port,
                  str(tmp_path)] for pid in range(2)])
    assert (tmp_path / "log_0.jsonl").exists()
    assert not (tmp_path / "log_1.jsonl").exists()
    got = torch.load(tmp_path / "digest.pt")
    want = testkit.run_chunks(2, 1, CHUNKS, device="cpu", params=True,
                              **testkit.CONFIG_KW)
    # Every step trains: each shard holds its 8 envs' first transitions.
    assert got["train_steps"] == CHUNKS * testkit.CONFIG_KW[
        "steps_per_chunk"]
    assert_digests_agree(got, want)


LOOP = ttrain.DQNTrainConfig(
    agent=DQNConfig(features=16, hidden=32, num_blocks=1, bf16=False,
                    dropout=0.0, memory_size=1024, epsilon=0.5),
    num_envs=32, updates_per_step=1, train_batch=16, steps_per_chunk=8,
    replay_shards=2, target_sync_episodes=4, prune_episodes=6, prune_n=2,
    checkpoint_episodes=8, seed=4)


def spawn(fn, n=2):
    return testkit.spawn_ranks(n, fn, device="cpu",
                               timeout_s=RANK_TIMEOUT_S)


FLOAT_ROW_KEYS = ("loss", "mean_return", "mean_score", "mean_length")


def assert_rows_agree(got, want):
    """Rows of two runs: every key equal, but the float sums' means within
    ``LOSS_RTOL`` and the host's ``steps_per_s``."""
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            if k in FLOAT_ROW_KEYS:
                assert b[k] == pytest.approx(a[k], rel=LOSS_RTOL), k
            elif k != "steps_per_s":
                assert b[k] == a[k], k


def test_train_loop_over_two_ranks_checkpoints_and_resumes(tmp_path):
    ck, log = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    logs = spawn(functools.partial(testkit.train_rank, LOOP, 10,
                                   checkpoint_dir=ck, log=log))
    # Every rank took the same decisions; rank 0 alone wrote the log.
    assert strip(logs[0]) == strip(logs[1])
    assert [r["episodes"] for r in read_jsonl(log)] == [
        r["episodes"] for r in logs[0]]
    assert logs[0][-1]["episodes"] >= 10
    mgr = CheckpointManager(ck)
    last = mgr.latest_step()
    assert last == logs[0][-1]["episodes"] and len(mgr.all_steps()) >= 2
    assert sorted(os.listdir(os.path.join(ck, "steps", str(last)))) == [
        "rank1.pt", "state.pt"]

    # One process holding both shards takes the same path, row for row.
    assert_rows_agree(logs[0], ttrain.train(LOOP, 10, "cpu"))

    copy = str(tmp_path / "copy")
    shutil.copytree(ck, copy)
    more = spawn(functools.partial(testkit.train_rank, LOOP, last + 5,
                                   checkpoint_dir=ck, resume=True))
    assert more[0][0]["env_steps"] == logs[0][-1]["env_steps"] + 32 * 8
    assert more[0][-1]["episodes"] > last
    # One process resumes the two ranks' checkpoint, both shards on it,
    # and takes the same path as the two ranks' resume.
    alone = ttrain.train(LOOP, last + 5, "cpu",
                         ckpt_manager=CheckpointManager(copy), resume=True)
    assert_rows_agree(alone, more[0])


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


FLAGS = ["--cpu", "--features", "16", "--hidden", "32", "--blocks", "1",
         "--no-bf16", "--envs", "16", "--batch", "8", "--memory-size", "512",
         "--steps-per-chunk", "16", "--updates-per-step", "1", "--episodes",
         "2", "--seed", "2"]


def strip(rows):
    return [{k: v for k, v in r.items() if k != "steps_per_s"}
            for r in rows]


@pytest.mark.parametrize("case", ["replay_shards", "data_parallel",
                                  "coordinator", "num_processes",
                                  "coordinator_resume"])
def test_cli_train_dqn_runs_the_multi_device_flags(case, tmp_path):
    ck, log = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    run = FLAGS + ["--checkpoint-dir", ck, "--log", log]
    port = str(testkit.free_port())
    if case == "replay_shards":
        assert run_cli(["train", "dqn", *run, "--replay-shards", "2"])[0] == 0
    elif case == "data_parallel":
        assert run_cli(["train", "dqn", *run, "--data-parallel", "2"])[0] == 0
    elif case == "coordinator":
        # One rank of a group: the run without the flags, bit for bit.
        assert run_cli(["train", "dqn", *run, "--coordinator",
                        f"127.0.0.1:{port}", "--num-processes", "1",
                        "--process-id", "0"])[0] == 0
        plain = str(tmp_path / "plain.jsonl")
        assert run_cli(["train", "dqn", *FLAGS, "--log", plain])[0] == 0
        assert strip(read_jsonl(log)) == strip(read_jsonl(plain))
    else:
        # Two processes, each one rank; then both resume (rank 0 rewrites
        # config.json while rank 1 reads it).
        def ranks(*more):
            run_workers([[sys.executable, "-m", "tpu2048_torch", "train",
                          "dqn", *run, "--data-parallel", "2",
                          "--coordinator", f"127.0.0.1:{port}",
                          "--num-processes", "2", "--process-id", str(pid),
                          *more] for pid in range(2)])

        ranks()
        if case == "coordinator_resume":
            before = read_jsonl(log)
            first = before[-1]
            port = str(testkit.free_port())
            ranks("--resume", "--episodes", str(first["episodes"] + 2))
            rows = read_jsonl(log)
            assert rows[:len(before)] == before
            assert rows[len(before)]["env_steps"] == (
                first["env_steps"] + 16 * 16)
            assert rows[-1]["episodes"] >= first["episodes"] + 2
    rows = read_jsonl(log)
    assert rows and rows[-1]["episodes"] >= 2
    assert rows[-1]["env_steps"] == 16 * 16 * len(rows)
    saved = json.load(open(os.path.join(ck, "config.json")))
    ranks = 1 if case in ("replay_shards", "coordinator") else 2
    assert saved["replay_shards"] == (1 if case == "coordinator" else 2)
    files = os.listdir(os.path.join(ck, "steps", str(rows[-1]["episodes"])))
    assert sorted(files) == [f"rank{r}.pt" for r in range(1, ranks)] + [
        "state.pt"]


@pytest.mark.parametrize("flags,message", [
    (["--replay-shards", "3", "--data-parallel", "2"], "multiple of"),
    (["--num-processes", "2"], "need --coordinator"),
    (["--process-id", "0"], "need --coordinator"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0"], "must equal --num-processes"),
    (["--coordinator", "127.0.0.1:1"], "needs --num-processes"),
    (["--coordinator", "127.0.0.1:1", "--data-parallel", "2",
      "--model-parallel", "2", "--num-processes", "2", "--process-id",
      "0"], "must equal --num-processes"),
])
def test_cli_train_dqn_exits_2_on_flags_that_disagree(flags, message,
                                                      capsys):
    assert main(["train", "dqn", "--cpu", *flags]) == 2
    assert message in capsys.readouterr().err


def test_dryrun_multichip_on_gloo_ranks(capsys):
    # An even count takes model_parallel 2, as JAX's dry run does: one data
    # row of 8 envs, 2 steps.
    digest = testkit.dryrun_multichip(2, device="cpu")
    assert digest["env_steps"] == 1 * 8 * 2 and digest["launches"] == 0
    assert "dryrun_multichip(2): mesh=(1, 2)" in capsys.readouterr().out


def test_mesh_and_layout_rules():
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.is_primary_host() and not mesh.is_initialized()
    assert mesh.create_mesh(mesh.MeshConfig(data_parallel=4),
                            4).shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="needs 4 ranks, only 2"):
        mesh.create_mesh(mesh.MeshConfig(data_parallel=4), 2)
    with pytest.warns(UserWarning, match="uses only 2 of 4"):
        mesh.create_mesh(mesh.MeshConfig(data_parallel=2), 4)
    # Tensor parallel: rank r at (r // M, r % M), as JAX lays devices.
    grid = mesh.create_mesh(mesh.MeshConfig(2, model_parallel=2), 4)
    assert grid.shape == {"data": 2, "model": 2}
    assert grid.ranks == ((0, 1), (2, 3))
    lay = mesh.rank_layout(128, 64, 4, rank_=1, world=2)
    assert (lay.shards, lay.lanes, lay.batch, lay.num_envs) == (
        range(2, 4), slice(64, 128), 32, 64)
    # Rank 3 of (2, 2): data row 1's shards and lanes, model index 1.
    lay = mesh.rank_layout(128, 64, 4, rank_=3, world=4, model_parallel=2)
    assert (lay.data_index, lay.model_index, lay.dp, lay.mp) == (1, 1, 2, 2)
    assert (lay.shards, lay.lanes, lay.batch) == (range(2, 4),
                                                  slice(64, 128), 32)
    for args, what in (((128, 64, 3, 0, 2), "replay shards"),
                       ((100, 64, 8, 0, 2), "envs"),
                       ((128, 20, 8, 0, 2), "learner batch")):
        with pytest.raises(ValueError, match=what):
            mesh.rank_layout(*args)
    with pytest.raises(ValueError, match="model groups of 2"):
        mesh.rank_layout(128, 64, 4, rank_=0, world=3, model_parallel=2)
    assert mesh.distributed_init(device="cpu") == torch.device("cpu")
    assert not mesh.is_initialized()
