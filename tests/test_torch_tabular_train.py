"""The slice as a whole: the port's tabular trainer against JAX
``init_train_state`` + ``train_chunk`` (fast engine on the ``lax`` backend,
``xla`` table backend), shaped reward, B = 64, capacity 2**10, 8 steps.

The port replays JAX's randomness: reset bits that rebuild JAX's initial
boards, the env bits of each step (``fold_in(PRNGKey(2048), seed)``), and
the agent's draws from the JAX key chain. Exploration starts at 1, so the
actions do not hinge on float near-ties. Integer state (key words,
``occupied``, ``dropped``, boards, episode counts, action counts, the stall
lanes) must be equal; Q words and the running sums within ``Q_RTOL``: the
shaped reward differs by float32 ulps (test_torch_rewards.py), and the TD
updates carry that on. JAX runs with ``resolve_updates``'s claim index
repaired (test_torch_tabular.py says why). A greedy step follows, on a
table whose top-two Q gap is 0.1, 100x and more the tolerance.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fast_env import endgame_boards
from test_torch_tabular import repaired_resolve, to_torch
from tpu2048.agents import tabular as jtab
from tpu2048.agents import tabular_fast as jtabf
from tpu2048.env import EnvConfig as JaxEnvConfig
from tpu2048.ops import board as jboard
from tpu2048.ops import pallas_step as jps
from tpu2048.training import tabular as jtrain
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.agents import tabular_fast as ttabf
from tpu2048_torch.cli.main import main
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.ops import board as tboard
from tpu2048_torch.training import tabular as ttrain

B, LOG2, STEPS, SEED = 64, 10, 8, 3
Q_RTOL = 1e-5  # of max(1, |x|): reward ulps carried through 8 TD steps
ROW_KEYS = {"episodes", "env_steps", "epsilon", "mean_return", "mean_score",
            "mean_length", "best_tile", "q_states", "dropped_updates",
            "action_counts", "steps_per_s"}


def reset_rows(boards_cm):
    """(8, B) bit rows whose reset rows 4-7 rebuild the given two-tile
    boards by the kernel's rule (see test_torch_eval.py)."""
    cells = np.asarray(boards_cm).T
    rows = np.zeros((8, cells.shape[0]), np.uint32)
    for lane, board in enumerate(cells):
        (p1, p2) = np.flatnonzero(board)
        rows[4, lane] = p1 << 1
        rows[5, lane] = (p2 - 1) << 1
        rows[6, lane] = 9 if board[p1] == 2 else 0
        rows[7, lane] = 9 if board[p2] == 2 else 0
    return rows


def configs(steps, exploration):
    agent = dict(capacity_log2=LOG2, exploration_rate=exploration,
                 exploration_min=min(exploration, 0.01))
    jcfg = jtrain.TabularTrainConfig(
        agent=jtab.TabularConfig(**agent), env=JaxEnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=steps, fast_backend="lax",
        table_backend="xla", seed=SEED)
    tcfg = ttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(**agent), env=EnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=steps, seed=SEED)
    return jcfg, tcfg


def jax_randomness(js, steps):
    """The env bits and agent draws JAX's chunk consumes, in order."""
    bits, draws = [], []
    rng, seed = js.rng, int(js.env_state.seed)
    for t in range(steps):
        rng, k_act = jax.random.split(rng)
        k_expl, k_rand = jax.random.split(k_act)
        draws.append((to_torch(jax.random.uniform(k_expl, (B,))),
                      to_torch(jax.random.randint(k_rand, (B,), 0, 4))))
        key = jax.random.fold_in(jax.random.PRNGKey(2048), seed + t)
        bits.append(to_torch(jax.random.bits(key, (8, B), jnp.uint32)))
    return bits, draws


def assert_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = Q_RTOL * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= tol).all(), name


def assert_states_agree(ts, js):
    data, jdata = ts.table.data.numpy()[:-1], np.asarray(js.table.data)[:-1]
    for word in (0, 1):
        np.testing.assert_array_equal(data[:, word::8].view(np.uint32),
                                      jdata[:, word::8], err_msg=f"key {word}")
    np.testing.assert_array_equal(ts.table.occupied.numpy(),
                                  np.asarray(js.table.occupied))
    assert int(ts.table.dropped) == int(js.table.dropped)
    for j in range(4):
        assert_close(data[:, 2 + j::8].view(np.float32),
                     jdata[:, 2 + j::8].view(np.float32), f"q{j}")
    tenv, jenv = ts.env_state, js.env_state
    for name in ("boards", "score", "episode_steps", "prev_max",
                 "consec_action", "consec_count", "last_consec_penalty"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(),
                                      np.asarray(getattr(jenv, name)), name)
    for name in ("episodes_done", "env_steps", "best_tile", "action_counts"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("sum_return", "sum_score", "sum_length"):
        assert_close(getattr(ts, name).numpy(), getattr(js, name), name)
    assert_close(tenv.episode_return.numpy(), jenv.episode_return,
                 "episode_return")


def start_both(jcfg, tcfg):
    """JAX's initial state and the port's, from the same reset boards; then
    the second half of the lanes gets dense endgame boards, so that games
    end within the steps."""
    js = jtrain.init_train_state(jcfg)
    bits, draws = jax_randomness(js, STEPS)
    boards = np.asarray(js.env_state.boards)
    replay = tfast.ReplayBits([to_torch(reset_rows(boards)), *bits])
    ts = ttrain.init_train_state(tcfg, replay)
    np.testing.assert_array_equal(ts.env_state.boards.numpy(), boards)

    late = np.asarray(jps.from_cell_major(js.env_state.boards)).copy()
    late[B // 2:] = endgame_boards(SEED, B - B // 2)
    cm = jps.to_cell_major(jnp.asarray(late))
    js = js.replace(env_state=js.env_state.replace(
        boards=cm, legal=jboard.legal_moves_mask(jnp.asarray(late))))
    ts.env_state.boards = to_torch(cm)
    ts.env_state.legal = tboard.legal_moves_mask(torch.from_numpy(late))
    return js, ts, replay, draws


def test_train_slice_matches_jax(monkeypatch):
    monkeypatch.setattr(jtabf, "resolve_updates", repaired_resolve())
    jcfg, tcfg = configs(STEPS, 1.0)
    js, ts, replay, draws = start_both(jcfg, tcfg)

    js, j_eps = jax.jit(lambda s: jtrain.train_chunk(jcfg, s))(js)
    ts, t_eps = ttrain.train_chunk(tcfg, ts, replay, ttabf.ReplayDraws(draws))
    assert float(t_eps) == float(j_eps)
    assert_states_agree(ts, js)
    assert int(ts.table.occupied.sum()) > B and int(ts.episodes_done) > 0

    # One greedy step on a table whose actions are 0.1 apart in every slot.
    rng = np.random.default_rng(SEED)
    slots = ts.table.data.shape[0] * 16
    q = (rng.random((slots, 1)) + 0.1 * np.stack(
        [rng.permutation(4) for _ in range(slots)])).astype(np.float32)
    jdata = np.asarray(js.table.data).copy()
    for j in range(4):
        jdata[:, 2 + j::8] = q[:, j].view(np.uint32).reshape(-1, 16)
    js = js.replace(table=js.table.replace(data=jnp.asarray(jdata)))
    ts.table.data.copy_(torch.from_numpy(jdata.view(np.int32)))
    jcfg, tcfg = configs(1, 0.0)
    jboards = jps.from_cell_major(js.env_state.boards)
    seen = np.asarray(jtabf.fast_lookup(js.table, jboards)).any(-1)
    assert seen.any()  # some lanes act greedily on a stored state
    bits, draws = jax_randomness(js, 1)
    js, _ = jax.jit(lambda s: jtrain.train_chunk(jcfg, s))(js)
    ts, _ = ttrain.train_chunk(tcfg, ts, tfast.ReplayBits(bits),
                               ttabf.ReplayDraws(draws))
    assert_states_agree(ts, js)


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_train_save_and_eval_on_cpu(tmp_path):
    table, log = str(tmp_path / "q.npz"), str(tmp_path / "m.jsonl")
    rc, _ = run_cli(["train", "tabular", "--cpu", "--episodes", "8",
                     "--batch", "16", "--capacity-log2", "10",
                     "--steps-per-chunk", "64", "--save", table, "--log",
                     log, "--seed", "1"])
    assert rc == 0
    from tpu2048.metrics.analyze import analyze
    from tpu2048_torch.metrics.logging import read_jsonl

    rows = read_jsonl(log)
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    assert rows[-1]["episodes"] >= 8 and rows[-1]["q_states"] > 0
    assert analyze(log)["dropped_updates"] == rows[-1]["dropped_updates"]
    loaded = jtab.load_qtable(table)  # the JAX package reads the file
    assert int(loaded.occupied.sum()) == rows[-1]["q_states"]

    rc, out = run_cli(["eval", "--policy", "tabular", "--table", table,
                       "--games", "8", "--eval-batch", "8", "--cpu",
                       "--reward", "shaped"])
    assert rc == 0
    summary = json.loads(out)
    assert summary["games"] == 8 and summary["score_mean"] > 0


@pytest.mark.parametrize("flags", [["--engine", "lax"]])
def test_cli_train_refuses_what_is_not_ported(flags, tmp_path):
    """``--engine lax`` was refused until the classic env was ported: now
    ``train tabular`` runs on it and ``eval --engine lax`` reads its
    table."""
    table, log = str(tmp_path / "q.npz"), str(tmp_path / "m.jsonl")
    rc, _ = run_cli(["train", "tabular", "--cpu", *flags, "--episodes", "4",
                     "--batch", "16", "--capacity-log2", "10",
                     "--steps-per-chunk", "64", "--save", table, "--log",
                     log])
    assert rc == 0
    from tpu2048_torch.metrics.logging import read_jsonl

    rows = read_jsonl(log)
    assert rows[-1]["episodes"] >= 4 and rows[-1]["q_states"] > 0
    assert sum(rows[-1]["action_counts"]) == rows[-1]["env_steps"]
    rc, out = run_cli(["eval", "--policy", "tabular", "--table", table,
                       "--games", "8", "--eval-batch", "8", "--cpu",
                       "--reward", "shaped", *flags])
    assert rc == 0
    summary = json.loads(out)
    assert summary["games"] == 8 and summary["batch_steps"] % 32 == 0


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_cli_train_refuses_the_jax_table_backends(backend, capsys):
    """JAX's plain table and its interpreted kernels have no counterpart on
    the card: exit 2 before any training."""
    assert main(["train", "tabular", "--cpu", "--table-backend",
                 backend]) == 2
    assert f"{backend!r} names a JAX backend" in capsys.readouterr().err
