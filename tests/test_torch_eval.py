"""The slice as a whole: greedy-DQN evaluation in the port against JAX.

JAX ``evaluate(greedy_dqn_policy(...), engine="fast", fast_backend="lax")``
plays 16 games at narrow width in float32 with ``max_steps=64``. The port's
``evaluate`` starts from the same reset boards and replays the same step
bits; the scores, max tiles, lengths and action counts must be equal.

Q agrees only within the float32 tolerance of test_torch_dqn_model.py, and
the Q of randomly initialised networks has near ties (a top-two gap of
~1e-5 in a few thousand choices), which that tolerance could decide either
way. So the head's bias spaces the four actions GAP apart and its kernel is
scaled down until the network's share of Q varies by less than GAP / 5: the
Q-values still run through every layer, and the greedy choice is the legal
action with the largest bias. The test checks that the smallest top-two
legal gap it saw exceeds 100x the float32 tolerance.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents.dqn import DQNConfig as JaxDQNConfig
from tpu2048.env import EnvConfig as JaxEnvConfig
from tpu2048.env import fast as jfast
from tpu2048.eval.evaluate import evaluate as jax_evaluate
from tpu2048.eval.evaluate import greedy_dqn_policy as jax_greedy
from tpu2048.eval.evaluate import random_legal_policy as jax_random
from tpu2048.models import dqn as jdqn
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.checkpoint.params import load_params, save_params
from tpu2048_torch.cli.main import main
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import EnvConfig
from tpu2048_torch.eval import evaluate as teval
from tpu2048_torch.models import dqn as tdqn
from tpu2048_torch.ops import step_kernel as sk

NARROW = dict(features=32, hidden=16, num_blocks=2)
NARROW_FLAGS = ["--features", "32", "--hidden", "16", "--blocks", "2",
                "--no-bf16"]
GAMES, MAX_STEPS, SEED = 16, 64, 3
F32_TOL = 1e-4  # of max(1, |q|max), as in test_torch_dqn_model.py
GAP = 0.05


def tie_free_params(seed):
    """Random flax params whose head puts the actions GAP apart."""
    model = jdqn.create_model(JaxDQNConfig(bf16=False, **NARROW))
    params = jax.tree.map(np.asarray,
                          jdqn.init_params(model, jax.random.PRNGKey(seed)))
    params["head"]["kernel"] = params["head"]["kernel"] * np.float32(0.02)
    params["head"]["bias"] = GAP * np.arange(4, dtype=np.float32)
    return model, params


def to_torch(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def reset_rows(boards_cm):
    """(8, B) bit rows whose reset rows 4-7 rebuild the given two-tile
    boards by the kernel's rule: p1 = (b4 >> 1) % 16, p2 from
    (b5 >> 1) % 15 skipping p1, value 4 iff b % 10 == 9."""
    cells = np.asarray(boards_cm).T  # (B, 16)
    rows = np.zeros((8, cells.shape[0]), np.uint32)
    for lane, board in enumerate(cells):
        (p1, p2) = np.flatnonzero(board)
        rows[4, lane] = p1 << 1
        rows[5, lane] = (p2 - 1) << 1  # p2 > p1, so the kernel adds 1 back
        rows[6, lane] = 9 if board[p1] == 2 else 0
        rows[7, lane] = 9 if board[p2] == 2 else 0
    return rows


def jax_step_bits(seed):
    """The bits JAX fast_step(backend="lax") draws at each step."""
    draw = jax.jit(lambda s: jax.random.bits(
        jax.random.fold_in(jax.random.PRNGKey(2048), s), (8, GAMES),
        jnp.uint32))
    step = 0
    while True:
        yield to_torch(draw(seed + step))
        step += 1


def test_greedy_eval_matches_jax(tmp_path):
    jmodel, params = tie_free_params(11)
    env_config = JaxEnvConfig(reward="simple", auto_reset=False)
    key = jax.random.PRNGKey(SEED)
    want = jax_evaluate(
        jax_greedy(jmodel, params), GAMES, key,
        env_config=env_config, batch_size=GAMES, max_steps=MAX_STEPS,
        engine="fast", fast_backend="lax",
    )

    # The reset state JAX's _evaluate_fast builds for its one batch.
    _, k_reset = jax.random.split(key)
    fcfg = jfast.for_backend(batch_size=GAMES, backend="lax",
                             env_config=env_config)
    jstate = jfast.fast_reset(fcfg, k_reset, GAMES)
    bits = tfast.ReplayBits(itertools.chain(
        [to_torch(reset_rows(jstate.boards))],
        jax_step_bits(int(jstate.seed))))

    save_params(tmp_path / "params.npz", params)
    model = tdqn.load_flax_params(
        tdqn.create_model(DQNConfig(bf16=False, **NARROW), "cpu"),
        load_params(tmp_path / "params.npz"))
    greedy = teval.greedy_dqn_policy(model)
    gaps = []

    def recording_policy(boards, legal):
        with torch.no_grad():
            q = model(boards)
        q_legal = torch.where(legal, q, -torch.inf).sort(-1, descending=True)
        two = legal.sum(-1) >= 2
        gaps.append((q_legal.values[two, 0] - q_legal.values[two, 1]).min()
                    / max(1.0, q.abs().max().item()))
        return greedy(boards, legal)

    got = teval.evaluate(recording_policy, GAMES, bits,
                         batch_size=GAMES, max_steps=MAX_STEPS)
    for name in ("scores", "max_tiles", "lengths", "action_counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.batch_steps == len(gaps) == 96  # 3 chunks of 32: no early end
    assert got.env_steps == 96 * GAMES
    assert min(gaps) > 100 * F32_TOL
    assert got.summary()["games"] == GAMES


def test_cli_eval_on_cpu(tmp_path, capsys):
    _, params = tie_free_params(0)
    save_params(tmp_path / "params.npz", params)
    rc = main(["eval", "--policy", "model", "--params",
               str(tmp_path / "params.npz"), "--games", "6",
               "--eval-batch", "4", "--seed", "1", *NARROW_FLAGS, "--cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["games"] == 6
    assert sum(summary["action_counts"].values()) > 0
    assert summary["env_steps"] > 0


def test_cli_eval_refusals(tmp_path, capsys):
    assert main(["eval", "--policy", "model", "--cpu"]) == 2
    assert "--params" in capsys.readouterr().err
    assert main(["eval", "--policy", "tabular", "--cpu"]) == 2
    assert "--table" in capsys.readouterr().err
    assert main(["eval", "--policy", "model", "--cpu", "--params",
                 str(tmp_path / "missing.npz")]) == 2
    assert main(["eval", "--policy", "tabular", "--cpu", "--table",
                 str(tmp_path / "missing.npz")]) == 2


@pytest.mark.parametrize("reward", ["simple", "shaped"])
def test_random_eval_matches_jax(reward):
    """JAX's random eval on its rollout path (``fast_backend="lax"``) and
    the port's on the same reset boards and step bits: equal results."""
    env_config = JaxEnvConfig(reward=reward, auto_reset=False)
    key = jax.random.PRNGKey(SEED)
    want = jax_evaluate(jax_random(), GAMES, key, env_config=env_config,
                        batch_size=GAMES, max_steps=32, engine="fast",
                        fast_backend="lax")
    _, k_reset = jax.random.split(key)
    fcfg = jfast.for_backend(batch_size=GAMES, backend="lax",
                             env_config=env_config)
    jstate = jfast.fast_reset(fcfg, k_reset, GAMES)
    bits = tfast.ReplayBits(itertools.chain(
        [to_torch(reset_rows(jstate.boards))],
        jax_step_bits(int(jstate.seed))))
    got = teval.evaluate(teval.random_legal_policy(), GAMES, bits,
                         env_config=EnvConfig(reward=reward,
                                              auto_reset=False),
                         batch_size=GAMES, max_steps=32)
    for name in ("scores", "max_tiles", "lengths", "action_counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.batch_steps == 48 and got.env_steps == 48 * GAMES


@pytest.mark.parametrize("reward", ["simple", "shaped"])
def test_cli_eval_random_on_cpu(reward, monkeypatch, capsys):
    """``eval --policy random`` plays on the rollout kernel's path, 16 steps
    a call, and never calls the step kernel."""
    calls = []
    rollout = sk.fused_env_rollout

    def counting(*args, **kwargs):
        calls.append(args[4])
        return rollout(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("random eval called the step kernel")

    monkeypatch.setattr(sk, "fused_env_rollout", counting)
    monkeypatch.setattr(sk, "fused_env_step", refuse)
    rc = main(["eval", "--policy", "random", "--games", "12",
               "--eval-batch", "8", "--reward", reward, "--seed", "4",
               "--cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["games"] == 12
    assert summary["batch_steps"] == 16 * len(calls) and set(calls) == {16}
    total_length = round(summary["length_mean"] * 12)
    assert sum(summary["action_counts"].values()) == total_length
    assert summary["score_mean"] > 0 and summary["best_tile"] >= 32

    result = teval.evaluate(teval.random_legal_policy(), 12,
                            tfast.PhiloxBits(4, "cpu"),
                            env_config=EnvConfig(reward=reward,
                                                 auto_reset=False),
                            batch_size=8)
    assert (result.scores > 0).all()
    assert result.action_counts.sum() == result.lengths.sum()
    assert result.summary()["score_mean"] == summary["score_mean"]


def test_random_policy_is_drawn_only_in_the_kernel():
    """The random-legal policy has no per-step function: called directly,
    it raises instead of drawing from a generator the eval does not own."""
    policy = teval.random_legal_policy()
    assert policy.in_kernel_random
    boards = torch.zeros((2, 4, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="rollout kernel"):
        policy(boards, torch.ones((2, 4), dtype=torch.bool))


def test_evaluate_refuses_the_lax_engine():
    model = tdqn.create_model(DQNConfig(bf16=False, **NARROW), "cpu")
    bits = tfast.GeneratorBits(0, "cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        teval.evaluate(teval.greedy_dqn_policy(model), 4, bits,
                       engine="lax")
