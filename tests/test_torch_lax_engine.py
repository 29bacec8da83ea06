"""The lax engine (the classic env under the eval harness and both
trainers) against JAX's ``engine="lax"`` on the same inputs.

The port's draw source computes JAX's key chain (``JaxKeyChain`` of
test_torch_env.py): the eval harness's and the trainers' spawns and reset
boards are JAX's. The greedy evaluations must give equal results. The
trainers are held as test_torch_tabular_train.py and
test_torch_dqn_train.py hold the fast engine's: integer state equal, Q and
the running sums within ``Q_RTOL`` (the shaped reward's float32 ulps,
carried by the TD updates), losses and weights within ``LOSS_RTOL`` and
``PARAM_ATOL``. A lax ``train dqn`` resumes bit for bit, and the fast and
lax random evals agree in distribution.
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
from test_torch_dqn_train import JaxChain, assert_loops_agree, state_equal
from test_torch_dqn_train import configs as dqn_configs
from test_torch_env import JaxKeyChain, port_state
from test_torch_eval import tie_free_params
from test_torch_fast_env import endgame_boards
from test_torch_tabular import repaired_resolve, to_torch
from test_torch_tabular_train import assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents import dqn as jdqn
from tpu2048.agents import tabular as jtab
from tpu2048.agents import tabular_fast as jtabf
from tpu2048.env import EnvConfig as JaxEnvConfig
from tpu2048.eval.evaluate import evaluate as jax_evaluate
from tpu2048.eval.evaluate import greedy_dqn_policy as jax_greedy_dqn
from tpu2048.eval.evaluate import greedy_tabular_policy as jax_greedy_tab
from tpu2048.training import dqn as jdtrain
from tpu2048.training import tabular as jttrain
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.agents import tabular_fast as ttabf
from tpu2048_torch.checkpoint.ckpt import CheckpointManager
from tpu2048_torch.checkpoint.params import load_params, save_params
from tpu2048_torch.cli.main import main
from tpu2048_torch.env import env as tenv
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.eval import evaluate as teval
from tpu2048_torch.models import dqn as tdqnm
from tpu2048_torch.ops import step_kernel as sk
from tpu2048_torch.training import dqn as tdtrain
from tpu2048_torch.training import tabular as tttrain

GAMES, MAX_STEPS, SEED = 16, 64, 7
B, LOG2, STEPS = 64, 10, 8
NARROW_EVAL = dict(features=32, hidden=16, num_blocks=2)


class JaxEvalChain:
    """The spawn source of JAX's lax ``evaluate``: a batch's reset keys a
    :class:`JaxKeyChain` with the next ``split`` of the eval's key, and
    each chunk of 32 steps splits the key once more (for the policy's
    keys)."""

    def __init__(self, key):
        self.key, self.chain, self.steps = key, None, 0

    def fresh(self, batch):
        for _ in range(self.steps // teval.STEPS_PER_CALL):
            self.key = jax.random.split(self.key)[0]
        self.key, k_reset = jax.random.split(self.key)
        self.chain, self.steps = JaxKeyChain(k_reset, batch), 0
        return self.chain.fresh(batch)

    def spawn(self, board):
        self.steps += 1
        return self.chain.spawn(board)


def assert_results_equal(got, want):
    for name in ("scores", "max_tiles", "lengths", "action_counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


# ---------------------------------------------------------------------------
# The lax eval harness
# ---------------------------------------------------------------------------


def test_lax_greedy_tabular_eval_matches_jax(tmp_path):
    """A table holding random Q for each game's first board, played
    greedily, shaped reward."""
    key = jax.random.PRNGKey(SEED)
    jcfg = JaxEnvConfig(reward="shaped", auto_reset=False)
    rng = np.random.default_rng(SEED)
    first = JaxKeyChain(jax.random.split(key)[1], GAMES).fresh(GAMES)
    table = jtab.qtable_init(LOG2)
    update = jax.jit(jtab.qtable_update, static_argnums=4)
    for a in range(4):
        table = update(table, jnp.asarray(first.numpy()),
                       jnp.full((GAMES,), a, jnp.int32),
                       jnp.asarray(rng.normal(size=GAMES), jnp.float32), 0.5)
    jtab.save_qtable(str(tmp_path / "q.npz"), table)
    want = jax_evaluate(jax_greedy_tab(table), GAMES, key, env_config=jcfg,
                        batch_size=GAMES, max_steps=MAX_STEPS, engine="lax")
    policy = teval.greedy_tabular_policy(
        ttab.load_qtable(str(tmp_path / "q.npz"), "cpu"))
    got = teval.evaluate(policy, GAMES, JaxEvalChain(key),
                         env_config=EnvConfig(reward="shaped",
                                              auto_reset=False),
                         batch_size=GAMES, max_steps=MAX_STEPS, engine="lax")
    assert_results_equal(got, want)
    assert got.batch_steps >= 32 and got.env_steps == got.batch_steps * GAMES


def test_lax_greedy_dqn_eval_matches_jax(tmp_path):
    jmodel, params = tie_free_params(SEED)
    key = jax.random.PRNGKey(SEED)
    jcfg = JaxEnvConfig(reward="simple", auto_reset=False)
    want = jax_evaluate(jax_greedy_dqn(jmodel, params), GAMES, key,
                        env_config=jcfg, batch_size=GAMES,
                        max_steps=MAX_STEPS, engine="lax")
    save_params(tmp_path / "params.npz", params)
    model = tdqnm.load_flax_params(
        tdqnm.create_model(tdqn.DQNConfig(bf16=False, **NARROW_EVAL), "cpu"),
        load_params(tmp_path / "params.npz"))
    got = teval.evaluate(teval.greedy_dqn_policy(model), GAMES,
                         JaxEvalChain(key), batch_size=GAMES,
                         max_steps=MAX_STEPS, engine="lax")
    assert_results_equal(got, want)
    assert got.batch_steps == 96  # no game ends within 64 steps
    assert got.summary()["games"] == GAMES


def test_quirk_env_resolves_to_lax_and_plays():
    """"auto" on a quirk env picks the lax engine (the kernel has no quirk
    mode); the random policy draws on the source's generator."""
    source = tenv.GeneratorSpawns(SEED, "cpu")
    cfg = EnvConfig(reward="simple", quirk_compat=True, auto_reset=False)
    calls = []
    step = sk.fused_env_step

    def refuse(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sk, "fused_env_step", refuse)
        got = teval.evaluate(teval.random_legal_policy(source.generator), 8,
                             source, env_config=cfg, batch_size=8)
    assert not calls
    assert (got.lengths > 10).all()
    assert got.action_counts.sum() == got.lengths.sum()
    with pytest.raises(ValueError, match="non-quirk"):
        teval.evaluate(teval.random_legal_policy(), 8, source,
                       env_config=cfg, engine="fast")


def test_random_legal_actions_are_uniform_over_the_legal_moves():
    gen = torch.Generator().manual_seed(SEED)
    n = 40000
    legal = torch.tensor([[True, False, True, True],
                          [False, False, False, False]]).repeat(n // 2, 1)
    actions = teval.random_legal_actions(legal, gen)
    first = np.bincount(actions[0::2].numpy(), minlength=4)
    none = np.bincount(actions[1::2].numpy(), minlength=4)
    assert first[1] == 0 and abs(first[[0, 2, 3]] - n / 6).max() < 0.05 * n / 6
    assert abs(none - n / 8).max() < 0.05 * n / 8  # all four where none is


def test_fast_and_lax_random_evals_agree_in_distribution():
    """As tests/test_fast_training.py:183 holds JAX's two engines: the
    streams differ, so the check is statistical (mean scores within four
    standard errors of their difference, every game longer than 10 steps,
    every direction played)."""
    n = 128
    cfg = EnvConfig(reward="simple", auto_reset=False)
    fast = teval.evaluate(teval.random_legal_policy(), n,
                          tfast.PhiloxBits(SEED, "cpu"), env_config=cfg,
                          batch_size=n, max_steps=1200, engine="fast")
    source = tenv.GeneratorSpawns(SEED, "cpu")
    lax = teval.evaluate(teval.random_legal_policy(source.generator), n,
                         source, env_config=cfg, batch_size=n,
                         max_steps=1200, engine="lax")
    for r in (fast, lax):
        assert len(r.scores) == n and (r.lengths > 10).all()
        assert (r.action_counts > 0).all()
        assert r.action_counts.sum() == r.lengths.sum()
    se = np.sqrt(fast.scores.var() / n + lax.scores.var() / n)
    assert abs(fast.scores.mean() - lax.scores.mean()) < 4 * se
    se = np.sqrt(fast.lengths.var() / n + lax.lengths.var() / n)
    assert abs(fast.lengths.mean() - lax.lengths.mean()) < 4 * se


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------


def tabular_configs(backend):
    agent = dict(capacity_log2=LOG2, exploration_rate=0.5,
                 exploration_min=0.01)
    jcfg = jttrain.TabularTrainConfig(
        agent=jtab.TabularConfig(**agent), env=JaxEnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=STEPS, engine="lax",
        table_backend=backend, seed=SEED)
    tcfg = tttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(**agent), env=EnvConfig(reward="shaped"),
        batch_size=B, steps_per_chunk=STEPS, engine="lax",
        table_backend="legacy" if backend == "legacy" else "auto",
        seed=SEED)
    return jcfg, tcfg


@pytest.mark.parametrize("backend", ["xla", "legacy"])
def test_lax_tabular_train_chunk_matches_jax(backend, monkeypatch):
    """Shaped reward, B=64, capacity 2**10, 8 steps, exploration 0.5; half
    the lanes on endgame boards so that episodes end and restart."""
    monkeypatch.setattr(jtabf, "resolve_updates", repaired_resolve())
    jcfg, tcfg = tabular_configs(backend)
    js = jttrain.init_train_state(jcfg)
    k_env = jax.random.split(jax.random.PRNGKey(SEED))[0]
    chain = JaxKeyChain(k_env, B)
    ts = tttrain.init_train_state(tcfg, chain)
    late = np.array(js.env_state.board)
    np.testing.assert_array_equal(ts.env_state.board.numpy(), late)
    late[B // 2:] = endgame_boards(SEED, B - B // 2)
    js = js.replace(env_state=js.env_state.replace(board=jnp.asarray(late)))
    ts.env_state.board = torch.from_numpy(late)
    draws = tabular_draws(js.rng)

    js, j_eps = jax.jit(lambda s: jttrain.train_chunk(jcfg, s))(js)
    ts, t_eps = tttrain.train_chunk(tcfg, ts, chain, ttabf.ReplayDraws(draws))
    assert float(t_eps) == float(j_eps)
    if backend == "legacy":
        for name in ("key_lo", "key_hi"):
            np.testing.assert_array_equal(
                getattr(ts.table, name).numpy().view(np.uint32),
                np.asarray(getattr(js.table, name)), name)
        assert_close(ts.table.q.numpy(), js.table.q, "q")
    else:
        data = ts.table.data.numpy()[:-1]
        jdata = np.asarray(js.table.data)[:-1]
        for word in (0, 1):
            np.testing.assert_array_equal(data[:, word::8].view(np.uint32),
                                          jdata[:, word::8])
        for j in range(4):
            assert_close(data[:, 2 + j::8].view(np.float32),
                         jdata[:, 2 + j::8].view(np.float32), f"q{j}")
    assert int(ts.table.dropped) == int(js.table.dropped)
    np.testing.assert_array_equal(ts.table.occupied.numpy(),
                                  np.asarray(js.table.occupied))
    tenv_state = port_state(js.env_state)
    for f in ("board", "score", "episode_steps", "prev_max", "consec_action",
              "consec_count", "done"):
        np.testing.assert_array_equal(getattr(ts.env_state, f).numpy(),
                                      getattr(tenv_state, f).numpy(), f)
    assert_close(ts.env_state.episode_return.numpy(),
                 js.env_state.episode_return, "episode_return")
    for name in ("episodes_done", "env_steps", "best_tile", "action_counts"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("sum_return", "sum_score", "sum_length"):
        assert_close(getattr(ts, name).numpy(), getattr(js, name), name)
    assert int(ts.episodes_done) > 0 and int(ts.table.occupied.sum()) > B


def tabular_draws(rng):
    """The agent's draws of JAX's tabular chunk: a split a step into the
    loop key and the action key, which splits into the explore and the
    random-action keys."""
    draws = []
    for _ in range(STEPS):
        rng, k_act = jax.random.split(rng)
        k_expl, k_rand = jax.random.split(k_act)
        draws.append((to_torch(jax.random.uniform(k_expl, (B,))),
                      to_torch(jax.random.randint(k_rand, (B,), 0, 4))))
    return draws


def test_lax_dqn_train_chunk_matches_jax():
    """test_torch_dqn_train.py's chunk (narrow float32 network, B=32, a
    256-slot buffer, update debt) on the lax engine, the actor's legal mask
    computed from the boards."""
    jcfg, tcfg = dqn_configs(engine="lax")
    model, js = jdtrain.init_loop_state(jcfg)
    params = jax.tree.map(jnp.asarray, tie_free(js.agent.params, SEED))
    tx = jdqn.make_optimizer(jcfg.agent)
    b = tcfg.num_envs
    late = np.array(js.env_state.board)
    late[b // 2:] = endgame_boards(SEED, b - b // 2)
    js = js.replace(
        agent=js.agent.replace(params=params, target_params=params,
                               opt_state=tx.init(params)),
        env_state=js.env_state.replace(board=jnp.asarray(late)))
    ts = tdtrain.init_loop_state(tcfg, "cpu")
    assert isinstance(ts.env_state, tenv.EnvState)
    carry(js.agent, ts.agent)
    ts.env_state = port_state(js.env_state)
    k_env = jax.random.split(jax.random.PRNGKey(tcfg.seed), 3)[0]
    ts.bits, ts.draws = JaxKeyChain(k_env, b), JaxChain(js.rng, 0)

    js, j_eps, _ = jax.jit(
        lambda s: jdtrain.train_chunk(jcfg, model, tx, s))(js)
    ts, t_eps = tdtrain.train_chunk(tcfg, ts)
    assert t_eps == float(j_eps)
    assert_loops_agree(ts, js, env_fields=(
        "board", "score", "move_score", "episode_steps", "episode_return",
        "done"))
    assert ts.episodes_done >= b // 4 and ts.agent.train_steps > 40
    assert (ts.agent.train_steps + ts.update_debt
            == tcfg.updates_per_episode * ts.episodes_done)


def test_lax_dqn_resume_continues_bit_identically(tmp_path):
    """With dropout on, so that the learner's generator is carried too;
    the env's generator is the classic env's spawn source."""
    _, tcfg = dqn_configs(engine="lax", steps_per_chunk=12,
                          updates_per_step=2)
    tcfg = dataclasses.replace(
        tcfg, agent=dataclasses.replace(tcfg.agent, dropout=0.5))
    straight = tdtrain.init_loop_state(tcfg, "cpu")
    assert isinstance(straight.bits, tenv.GeneratorSpawns)
    tdtrain.train_chunk(tcfg, straight)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, straight)
    tdtrain.train_chunk(tcfg, straight)
    resumed = tdtrain.init_loop_state(dataclasses.replace(tcfg, seed=99),
                                      "cpu")
    mgr.restore(1, resumed)
    tdtrain.train_chunk(tcfg, resumed)
    state_equal(resumed, straight)
    assert straight.agent.train_steps > 0


# ---------------------------------------------------------------------------
# Through the CLI
# ---------------------------------------------------------------------------


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


NARROW_FLAGS = ["--cpu", "--features", "32", "--hidden", "16", "--blocks",
                "1", "--no-bf16", "--envs", "16", "--batch", "8",
                "--memory-size", "512", "--steps-per-chunk", "32",
                "--updates-per-episode", "5", "--seed", "1"]


def test_cli_train_dqn_lax_runs_and_resumes(tmp_path):
    """``train dqn --engine lax`` trains, checkpoints and writes env 0's
    debug rows; ``--resume`` without ``--engine`` (or with another) keeps
    the run's engine, whose loop state the checkpoint holds; ``eval`` plays
    the weights on it."""
    ck, log = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    trace = tmp_path / "trace.csv"
    rc, _ = run_cli(["train", "dqn", *NARROW_FLAGS, "--episodes", "2",
                     "--engine", "lax", "--checkpoint-dir", ck, "--log",
                     log, "--debug-csv", str(trace)])
    assert rc == 0
    saved = json.load(open(f"{ck}/config.json"))
    assert saved["engine"] == "lax"
    from tpu2048_torch.metrics.logging import read_jsonl

    rows = read_jsonl(log)
    last = rows[-1]
    assert last["episodes"] >= 2 and sum(last["tile_hist"]) == last[
        "episodes"]
    lines = trace.read_text().splitlines()
    assert lines[0].startswith("Episode,Action,Legal Moves")
    assert len(lines) == 1 + last["env_steps"] // 16
    rc, _ = run_cli(["train", "dqn", "--cpu", "--episodes",
                     str(last["episodes"] + 1), "--checkpoint-dir", ck,
                     "--resume", "--engine", "fast", "--log", log])
    assert rc == 0
    more = read_jsonl(log)[len(rows):]
    assert more and more[0]["env_steps"] == last["env_steps"] + 16 * 32
    assert json.load(open(f"{ck}/config.json"))["engine"] == "lax"
    rc, out = run_cli(["eval", "--policy", "model", "--checkpoint-dir", ck,
                       "--cpu", "--games", "4", "--eval-batch", "4"])
    assert rc == 0 and json.loads(out)["games"] == 4


def test_restore_config_follows_the_saved_engine(tmp_path):
    """The JAX CLI's rule: the saved engine wins, and a config.json
    without one means lax."""
    from tpu2048_torch.cli.main import _restore_config, build_parser

    args = build_parser().parse_args(["train", "dqn", "--engine", "fast"])
    (tmp_path / "config.json").write_text(json.dumps({"seed": 0}))
    assert _restore_config(args, str(tmp_path)).engine == "lax"
    (tmp_path / "config.json").write_text(json.dumps({"engine": "auto"}))
    assert _restore_config(args, str(tmp_path)).engine == "auto"
    assert _restore_config(args, str(tmp_path / "none")).engine == "fast"


@pytest.mark.parametrize("reward", ["simple", "shaped"])
def test_cli_eval_lax_random_on_cpu(reward, capsys):
    rc = main(["eval", "--policy", "random", "--engine", "lax", "--cpu",
               "--games", "6", "--eval-batch", "4", "--reward", reward])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["games"] == 6
    assert sum(summary["action_counts"].values()) == round(
        summary["length_mean"] * 6)
    assert summary["batch_steps"] % 32 == 0
