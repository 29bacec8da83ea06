"""The slice as a whole: the port's DQN ``train_chunk`` against JAX
``init_loop_state`` + ``train_chunk`` (fast engine on its ``lax``
backend), simple reward with the terminal bonus, a narrow float32 network
(features 32, hidden 16, 1 block, dropout 0) whose head puts the actions
0.05 apart, B = 32, a 256-slot buffer (it wraps), batch 8, update debt of 4
updates an episode.

The port replays JAX's randomness through its own draw and bit sources:
``split(rng, 3)`` a step into the loop key, the select key and the learn
key; the select draws from the select key; the sample indices from the
learn key's chain, one split an update; the env bits from
``fold_in(PRNGKey(2048), seed + t)``. Half the lanes start on dense endgame
boards with a 2048 or two 1024s, so episodes end (with terminal bonuses
and LR-hook triggers) and the debt drains within the chunk.

Integer state must be equal: boards, legal masks, scores, the buffer's
slots, ``ptr``, ``size`` and ``max_priority``, the dedup caches, the
counters, the update count, ``tile_hist``, ``best_tile`` and the debt; the
running sums of integer-valued rewards, lengths and tiles too, and the LR
and epsilon (float32 on both sides). The loss sums and the parameters go
through float32 sums in another order: ``LOSS_RTOL`` of max(1, |x|) and
``PARAM_ATOL`` (the largest difference seen here is below a tenth of it).
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dqn_agent import carry, tie_free
from test_torch_fast_env import endgame_boards
from test_torch_tabular import to_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents import dqn as jdqn
from tpu2048.env import EnvConfig as JaxEnvConfig
from tpu2048.ops import board as jboard
from tpu2048.ops import pallas_step as jps
from tpu2048.training import dqn as jtrain
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.checkpoint.ckpt import CheckpointManager
from tpu2048_torch.cli.main import main
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.models.dqn import flax_to_torch_layout
from tpu2048_torch.replay import buffer as replaylib
from tpu2048_torch.training import dqn as ttrain

B, STEPS, SEED = 32, 24, 5
NARROW = dict(features=32, hidden=16, num_blocks=1, bf16=False, dropout=0.0,
              memory_size=256)
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
ROW_KEYS = {"episodes", "env_steps", "epsilon", "lr", "buffer_size",
            "train_steps", "mean_return", "mean_score", "mean_length",
            "best_tile", "loss", "tile_hist", "steps_per_s", "update_debt"}
TRAIN = dict(num_envs=B, train_batch=8, steps_per_chunk=STEPS,
             updates_per_episode=4, seed=SEED)


def configs(**over):
    train = dict(TRAIN, **over)
    jcfg = jtrain.DQNTrainConfig(
        agent=jdqn.DQNConfig(**NARROW), fast_backend="lax",
        env=JaxEnvConfig(reward="simple", terminal_bonus=True), **train)
    tcfg = ttrain.DQNTrainConfig(
        agent=tdqn.DQNConfig(**NARROW),
        env=EnvConfig(reward="simple", terminal_bonus=True), **train)
    return jcfg, tcfg


class JaxChain:
    """Draw and bit source that replays the JAX loop's key chain."""

    def __init__(self, rng, seed):
        self.rng, self.seed, self.learn = rng, int(seed), None

    def select(self, b):
        self.rng, k_act, self.learn = jax.random.split(self.rng, 3)
        k_explore, k_rand, k_rand_legal = jax.random.split(k_act, 3)
        return (to_torch(jax.random.uniform(k_explore, (b,))),
                to_torch(jax.random.randint(k_rand, (b,), 0, 4)),
                to_torch(jax.random.uniform(k_rand_legal, (b,))))

    def indices(self, buffer, batch, alpha):
        assert alpha == 0.0
        self.learn, k_sample = jax.random.split(self.learn)
        key = jax.random.split(k_sample, 1)[0]  # the shard's key
        high = max(int(buffer.size), 1)
        return to_torch(jax.random.randint(key, (batch,), 0, high))

    def bits(self, b):
        key = jax.random.fold_in(jax.random.PRNGKey(2048), self.seed)
        self.seed += 1
        return to_torch(jax.random.bits(key, (8, b), jnp.uint32))


def start_both(jcfg, tcfg):
    """JAX's loop state with a tie-free head and half the lanes on endgame
    boards, and the port's carrying the same agent, boards and keys."""
    model, js = jtrain.init_loop_state(jcfg)
    params = jax.tree.map(jnp.asarray, tie_free(js.agent.params, SEED))
    tx = jdqn.make_optimizer(jcfg.agent)
    late = np.array(jps.from_cell_major(js.env_state.boards))
    late[B // 2:] = endgame_boards(SEED, B - B // 2)
    js = js.replace(
        agent=js.agent.replace(params=params, target_params=params,
                               opt_state=tx.init(params)),
        env_state=js.env_state.replace(
            boards=jps.to_cell_major(jnp.asarray(late)),
            legal=jboard.legal_moves_mask(jnp.asarray(late))))
    ts = ttrain.init_loop_state(tcfg, "cpu")
    carry(js.agent, ts.agent)
    ts.env_state.boards = to_torch(js.env_state.boards)
    ts.env_state.legal = to_torch(js.env_state.legal)
    chain = JaxChain(js.rng, js.env_state.seed)
    ts.bits, ts.draws = chain.bits, chain
    return model, tx, js, ts


def assert_close(got, want, rtol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max(initial=0) <= rtol, f"{name}: {err.max():.3e}"


def assert_loops_agree(ts, js, env_fields=("boards", "legal", "score",
                                           "episode_steps",
                                           "episode_return")):
    for name in env_fields:
        np.testing.assert_array_equal(getattr(ts.env_state, name).numpy(),
                                      np.asarray(getattr(js.env_state, name)),
                                      name)
    for name in ("s", "ns", "saved_count", "last_saved"):
        np.testing.assert_array_equal(getattr(ts.dedup, name).numpy(),
                                      np.asarray(getattr(js.dedup, name)),
                                      name)
    c = ts.buffer.capacity
    for name in ("boards", "next_boards", "actions", "rewards", "dones",
                 "priorities"):
        np.testing.assert_array_equal(getattr(ts.buffer, name).numpy()[:c],
                                      np.asarray(getattr(js.buffer, name))[0],
                                      name)
    for name in ("ptr", "size", "max_priority"):
        assert (getattr(ts.buffer, name).item()
                == np.asarray(getattr(js.buffer, name))[0]), name
    for name in ("episodes_done", "env_steps", "update_debt", "loss_count"):
        assert getattr(ts, name) == int(getattr(js, name)), name
    for name in ("best_tile", "tile_hist", "sum_return", "sum_score",
                 "sum_length", "sum_final_tile"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.agent.step_counter == int(js.agent.step_counter)
    assert ts.agent.train_steps == int(js.agent.train_steps)
    assert tdqn.current_lr(ts.agent) == float(jdqn.current_lr(js.agent))
    for name in ("loss_sum", "last_loss"):
        assert_close(getattr(ts, name).numpy(), getattr(js, name), LOSS_RTOL,
                     name)
    tparams = ts.agent.model.state_dict()
    jparams = flax_to_torch_layout(ts.agent.model,
                                   jax.tree.map(np.asarray, js.agent.params))
    for name, want in jparams.items():
        err = (tparams[name] - want).abs().max().item()
        assert err <= PARAM_ATOL, f"param {name}: {err:.3e}"


def test_train_chunk_matches_jax():
    jcfg, tcfg = configs()
    model, tx, js, ts = start_both(jcfg, tcfg)
    js, j_eps, _ = jax.jit(
        lambda s: jtrain.train_chunk(jcfg, model, tx, s))(js)
    ts, t_eps = ttrain.train_chunk(tcfg, ts)
    assert t_eps == float(j_eps)
    assert_loops_agree(ts, js)
    # The chunk did what it is here to test: the ring wrapped, episodes
    # ended with bonuses and LR decays, the debt drained through updates.
    assert int(ts.buffer.size) == ts.buffer.capacity
    assert ts.episodes_done >= B // 4 and ts.agent.train_steps > 40
    assert tdqn.current_lr(ts.agent) < float(np.float32(5e-5))
    assert (ts.agent.train_steps + ts.update_debt
            == tcfg.updates_per_episode * ts.episodes_done)


def test_fixed_updates_per_step_matches_jax():
    jcfg, tcfg = configs(updates_per_step=2, steps_per_chunk=8)
    model, tx, js, ts = start_both(jcfg, tcfg)
    js, _, _ = jax.jit(lambda s: jtrain.train_chunk(jcfg, model, tx, s))(js)
    ts, _ = ttrain.train_chunk(tcfg, ts)
    assert_loops_agree(ts, js)
    assert ts.agent.train_steps == 2 * 8 and ts.update_debt == 0


def state_equal(a, b):
    """Two port loop states hold the same values, bit for bit."""
    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        else:
            assert x == y, path
    walk(a.state_dict(), b.state_dict(), "")


def test_resume_continues_bit_identically(tmp_path):
    """With dropout on, so that the learner's generator is carried too."""
    _, tcfg = configs(steps_per_chunk=12, updates_per_step=2)
    tcfg = dataclasses.replace(
        tcfg, agent=dataclasses.replace(tcfg.agent, dropout=0.5))
    straight = ttrain.init_loop_state(tcfg, "cpu")
    ttrain.train_chunk(tcfg, straight)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.save(1, straight)
    ttrain.train_chunk(tcfg, straight)
    assert straight.agent.train_steps > 0

    resumed = ttrain.init_loop_state(dataclasses.replace(tcfg, seed=99),
                                     "cpu")
    mgr.restore(1, resumed)
    ttrain.train_chunk(tcfg, resumed)
    state_equal(resumed, straight)
    for step in (2, 3, 4):
        mgr.save(step, straight)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_milestone_and_prune_on_resume(tmp_path):
    """A lane that ends holding a 2048 writes the milestone checkpoint,
    which ``restore_params_only`` reads by name; a resume with
    ``prune_on_resume`` prunes the restored buffer."""
    from tpu2048_torch.checkpoint.ckpt import restore_params_only
    from tpu2048_torch.ops import board as tboard
    from tpu2048_torch.ops.step_kernel import to_cell_major

    _, tcfg = configs(steps_per_chunk=8)
    state = ttrain.init_loop_state(tcfg, "cpu")
    late = torch.from_numpy(endgame_boards(SEED, B))
    state.env_state.boards = to_cell_major(late)
    state.env_state.legal = tboard.legal_moves_mask(late)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    logs = ttrain.train(tcfg, 1, state=state, ckpt_manager=mgr)
    ep = logs[-1]["episodes"]
    assert logs[-1]["best_tile"] == 2048 and mgr.named() == [
        f"tile_2048_ep{ep}"]
    tag, module = restore_params_only(mgr.directory, None, tcfg.agent,
                                      named=f"tile_2048_ep{ep}",
                                      device="cpu")
    assert tag == f"tile_2048_ep{ep}" and not module.training
    for a, b in zip(module.parameters(), state.agent.model.parameters()):
        assert torch.equal(a, b)
    assert mgr.latest_step() == ep
    with pytest.raises(FileNotFoundError, match="tile_512_ep1"):
        restore_params_only(mgr.directory, None, tcfg.agent,
                            named="tile_512_ep1", device="cpu")

    pruned = ttrain.init_loop_state(
        dataclasses.replace(tcfg, prune_on_resume=3), "cpu")
    ttrain.train(dataclasses.replace(tcfg, prune_on_resume=3), ep,
                 state=pruned, ckpt_manager=mgr, resume=True)
    want = replaylib.prune_low_score_episodes(state.buffer, 3)
    assert int(want.size) < int(state.buffer.size)
    c = want.capacity
    for name in ("boards", "rewards", "dones"):
        assert torch.equal(getattr(pruned.buffer, name)[:c],
                           getattr(want, name)[:c]), name
    assert int(pruned.buffer.size) == int(want.size)
    assert int(pruned.buffer.ptr) == int(want.ptr)


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_rollback_restores_and_the_loop_ends(store, tmp_path):
    """A drop of -1e9 makes every block "regress": the loop restores its
    block checkpoint at most twice in a row and still ends."""
    _, tcfg = configs(rollback=True, rollback_block=4, rollback_drop=-1e9,
                      rollback_store=store, steps_per_chunk=8,
                      target_sync_episodes=4, prune_episodes=8, prune_n=2)
    mgr = CheckpointManager(str(tmp_path / "rb")) if store == "disk" else None
    logs = ttrain.train(tcfg, 20, "cpu", ckpt_manager=mgr)
    assert logs[-1]["episodes"] >= 20 and logs[-1]["rollbacks"] >= 2
    eps_seq = [r["episodes"] for r in logs]
    assert any(b < a for a, b in zip(eps_seq, eps_seq[1:]))
    assert set(logs[-1]) == ROW_KEYS | {"rollbacks"}
    if mgr:
        assert mgr.has_named("block_checkpoint")


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


NARROW_FLAGS = ["--cpu", "--features", "32", "--hidden", "16", "--blocks",
                "1", "--no-bf16", "--envs", "16", "--batch", "8",
                "--memory-size", "512", "--steps-per-chunk", "32",
                "--updates-per-episode", "5", "--seed", "1"]


def test_cli_train_resume_and_eval_on_cpu(tmp_path):
    ck, log = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--episodes", "4",
                     "--checkpoint-dir", ck, "--log", log])
    assert rc == 0
    from tpu2048.metrics.analyze import analyze
    from tpu2048_torch.metrics.logging import read_jsonl

    rows = read_jsonl(log)
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    last = rows[-1]
    assert last["episodes"] >= 4 and sum(last["tile_hist"]) == last[
        "episodes"]
    assert last["train_steps"] + last["update_debt"] == 5 * last["episodes"]
    assert np.isfinite(last["loss"]) and last["epsilon"] < 0.9
    assert analyze(log)["episodes"] == last["episodes"]
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == last["episodes"]
    saved = json.load(open(f"{ck}/config.json"))
    assert saved["features"] == 32 and saved["envs"] == 16

    # --resume takes the widths from config.json and continues the run.
    rc, _ = run_cli(["train", "dqn", "--cpu", "--episodes",
                     str(last["episodes"] + 1), "--checkpoint-dir", ck,
                     "--resume", "--log", log])
    assert rc == 0
    more = read_jsonl(log)[len(rows):]
    assert more and more[0]["env_steps"] == last["env_steps"] + 16 * 32

    rc, out = run_cli(["eval", "--policy", "model", "--checkpoint-dir", ck,
                       "--cpu", "--games", "8", "--eval-batch", "8"])
    assert rc == 0
    summary = json.loads(out)
    assert summary["games"] == 8 and summary["score_mean"] > 0
    rc, _ = run_cli(["eval", "--policy", "model", "--checkpoint-dir", ck,
                     "--cpu", "--step", "12345"])
    assert rc == 2


def test_cli_warm_start_and_stop_at_tile(tmp_path, capsys):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    src_log, log = str(tmp_path / "s.jsonl"), str(tmp_path / "w.jsonl")
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--episodes", "1",
                     "--checkpoint-dir", src, "--log", src_log])
    assert rc == 0
    from tpu2048_torch.metrics.logging import read_jsonl

    src_steps = read_jsonl(src_log)[-1]["env_steps"]
    assert CheckpointManager(src).latest_step() is not None
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--episodes", "100",
                     "--warm-start", src, "--checkpoint-dir", dst,
                     "--log", log, "--stop-at-tile", "2"])
    assert rc == 0
    rows = read_jsonl(log)
    assert len(rows) == 1  # best tile >= 2 after the first chunk
    # Fresh counters, carried epsilon counter: the chunk's last step ran at
    # the source's steps plus 31 steps of 16 envs.
    assert rows[0]["env_steps"] == 16 * 32
    assert rows[0]["epsilon"] == tdqn.epsilon_value(
        tdqn.DQNConfig(), src_steps + 16 * 31)
    capsys.readouterr()
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--warm-start",
                     str(tmp_path / "missing")])
    assert rc == 2
    assert "--warm-start" in capsys.readouterr().err
    assert not (tmp_path / "missing").exists()  # a read creates nothing
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--warm-start", src,
                     "--warm-start-named", "tile_2048_ep1"])
    assert rc == 2


@pytest.mark.parametrize("flags", [["--model-parallel", "2"]])
def test_cli_train_dqn_refuses_what_is_not_ported(flags, capsys, tmp_path):
    """Once refused, ``--model-parallel 2`` now runs: two processes under
    ``--coordinator``, one data row of two model ranks, take the path of
    one process without the flags; a grid that is not the process count
    still exits 2."""
    import sys

    from test_torch_parallel import assert_rows_agree, run_workers
    from tpu2048_torch.metrics.logging import read_jsonl
    from tpu2048_torch.parallel.testkit import free_port

    run = [*NARROW_FLAGS, "--episodes", "2"]
    log, plain = str(tmp_path / "m.jsonl"), str(tmp_path / "plain.jsonl")
    port = str(free_port())
    run_workers([[sys.executable, "-m", "tpu2048_torch", "train", "dqn",
                  *run, *flags, "--data-parallel", "1", "--coordinator",
                  f"127.0.0.1:{port}", "--num-processes", "2",
                  "--process-id", str(pid), "--log", log]
                 for pid in range(2)])
    assert run_cli(["train", "dqn", *run, "--log", plain])[0] == 0
    rows = read_jsonl(log)
    assert rows[-1]["episodes"] >= 2
    assert_rows_agree(rows, read_jsonl(plain))
    assert main(["train", "dqn", *run, *flags, "--data-parallel", "2",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 "2", "--process-id", "0"]) == 2
    assert "must equal --num-processes" in capsys.readouterr().err
