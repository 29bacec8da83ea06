"""The harness at test sizes on the CPU: each cell's run comes out correct
against the plain reference, the control and every fault of the timed path
come out not correct, and a run loads nothing of JAX. The reference's game
rules are held to the port's plain env here (the reference itself imports
nothing of the port). Tests marked ``card`` run the cells on a CUDA card at
their own sizes."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import core, harness
from benchmark.reference import game
from benchmark.tests import tiny

CELLS = ["dqn_train", "tabular_train", "dqn_eval_greedy", "dqn_play"]
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _run(root, name, seconds=0.3, trace=False, control=False, seed=SEED):
    return harness.run_cell(core.Cell(name, root), seed, seconds, trace,
                            "cpu", control=control)


def test_word_step_is_the_kernel_rule():
    from tpu2048_torch.ops import step_kernel as sk

    g = torch.Generator().manual_seed(3)
    b = 4096
    boards = torch.randint(0, 12, (b, 16), generator=g)
    boards[boards < 4] = 0
    actions = torch.randint(0, 4, (b,), generator=g, dtype=torch.int32)
    words = torch.randint(-2**31, 2**31, (8, b), generator=g,
                          dtype=torch.int32)
    force = torch.rand(b, generator=g) < 0.1
    for fd in (None, force):
        out = sk.plain_env_step(boards.to(torch.int8).T.contiguous(),
                                actions, words, fd, emit_pre_reset=True)
        ref = game.word_step(boards, actions.long(), words.long(), fd)
        assert torch.equal(out[0].T.long(), ref["final"])
        assert torch.equal(out[1].long(), ref["score"])
        assert torch.equal(out[2], ref["moved"])
        assert torch.equal(out[3], ref["done"])
        assert torch.equal(out[4].long(), ref["max_exp"])
        assert torch.equal(out[5].long(), ref["second_exp"])
        assert torch.equal(out[-1].T.long(), ref["new"])


def test_uniform_step_is_the_classic_env_rule():
    from tpu2048_torch.env import env as envlib

    g = torch.Generator().manual_seed(4)
    b = 2048
    boards = torch.randint(0, 10, (b, 4, 4), generator=g, dtype=torch.int8)
    boards[boards < 3] = 0
    actions = torch.randint(0, 4, (b,), generator=g, dtype=torch.int32)
    u = torch.rand((2, b), generator=g)
    cfg = envlib.EnvConfig(auto_reset=False)
    state = envlib.reset(cfg, envlib.ReplaySpawns([], [boards]), b)
    idx, val = envlib.board_ops.sample_spawn(
        envlib.board_ops.select_move(*envlib.board_ops.move_all(boards),
                                     actions)[0], u[0], u[1])
    new, ts = envlib.step_with_spawn(cfg, state, actions, idx, val)
    ref, score, moved, over = game.uniform_step(boards.reshape(b, 16).long(),
                                                actions.long(), u)
    assert torch.equal(new.board.reshape(b, 16).long(), ref)
    assert torch.equal(ts.merge_score.long(), score)
    assert torch.equal(ts.valid, moved)
    assert torch.equal(ts.done, over)


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_at_test_size(root, name):
    line = _run(root, name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(root, name):
    line = _run(root, name, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(root, name):
    """The reference in the lower precision, in the program's place,
    reads a larger gap than the program on some float number. The traced
    run's fixed amount of work, not a time, sets the positions compared,
    so that a slow machine compares as many."""
    line = _run(root, name, trace=True, control=True)
    floats = [k for k, c in line["checks"].items()
              if isinstance(c["value"], float)]
    assert floats
    assert any(line["control"][k]["value"] > line["checks"][k]["value"]
               for k in floats)


def _optimizer_left_still(monkeypatch):
    from tpu2048_torch.agents import dqn as dqnlib

    train = dqnlib.train_step

    def broken(config, state, batch, grad_reduce=None):
        step = state.optimizer.step
        state.optimizer.step = lambda *a, **k: None
        try:
            return train(config, state, batch, grad_reduce)
        finally:
            state.optimizer.step = step

    monkeypatch.setattr(dqnlib, "train_step", broken)


def _half_batch(monkeypatch):
    from tpu2048_torch.agents import dqn as dqnlib

    train = dqnlib.train_step

    def broken(config, state, batch, grad_reduce=None):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return train(config, state, half, grad_reduce)

    monkeypatch.setattr(dqnlib, "train_step", broken)


def _env_answer_altered(monkeypatch):
    from tpu2048_torch.ops import step_kernel as sk

    step = sk.fused_env_step

    def broken(boards, *args, **kw):
        out = list(step(boards, *args, **kw))
        out[0] = out[0].clone()
        out[0][0, 0] = out[0][0, 0] + 1
        return tuple(out)

    monkeypatch.setattr(sk, "fused_env_step", broken)


def _table_left_still(monkeypatch):
    from tpu2048_torch.agents import tabular_fast as tabf

    monkeypatch.setattr(tabf, "fast_update",
                        lambda packed, *a, **k: packed)


def _table_half_batch(monkeypatch):
    from tpu2048_torch.agents import tabular_fast as tabf

    update = tabf.fast_update

    def broken(packed, probe, actions, targets, lr):
        q_sa = probe[-1].gather(1, actions.long().view(-1, 1))[:, 0]
        half = len(targets) // 2
        return update(packed, probe, actions,
                      torch.cat([targets[:half], q_sa[half:]]), lr)

    monkeypatch.setattr(tabf, "fast_update", broken)


def _env_left_still(monkeypatch):
    from tpu2048_torch.env import fast as fastlib

    step = fastlib.fast_step

    def broken(config, state, *args, **kw):
        _, ts = step(config, state, *args, **kw)
        return state, ts

    monkeypatch.setattr(fastlib, "fast_step", broken)


def _policy_half_batch(monkeypatch):
    from tpu2048_torch.eval import evaluate as ev

    greedy = ev._greedy

    def broken(model, boards, legal):
        actions = greedy(model, boards, legal)
        half = len(actions) // 2
        return torch.cat([actions[:half], (actions[half:] + 1) % 4])

    monkeypatch.setattr(ev, "_greedy", broken)


def _classic_left_still(monkeypatch):
    from tpu2048_torch.env import env as envlib

    step = envlib.step

    def broken(config, state, action, source):
        _, ts = step(config, state, action, source)
        return state, ts

    monkeypatch.setattr(envlib, "step", broken)


def _policy_answer_altered(monkeypatch):
    from tpu2048_torch.eval import evaluate as ev

    greedy = ev._greedy
    monkeypatch.setattr(ev, "_greedy", lambda model, boards, legal:
                        (greedy(model, boards, legal) + 1) % 4)


FAULTS = [
    ("dqn_train", _optimizer_left_still),
    ("dqn_train", _half_batch),
    ("dqn_train", _env_answer_altered),
    ("tabular_train", _table_left_still),
    ("tabular_train", _table_half_batch),
    ("tabular_train", _env_answer_altered),
    ("dqn_eval_greedy", _env_left_still),
    ("dqn_eval_greedy", _policy_half_batch),
    ("dqn_eval_greedy", _env_answer_altered),
    ("dqn_play", _classic_left_still),
    ("dqn_play", _policy_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(root, name)
    assert not line["correct"], line["checks"]


def test_a_run_loads_nothing_of_jax(root):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import core, harness\n"
        "line = harness.run_cell(core.Cell('dqn_eval_greedy', Path(%r)), 1,"
        " 0.1, False, 'cpu')\n"
        "print(json.dumps([line['correct'], core.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] == "
        "'tpu2048_torch')[:1]]))\n" % (str(core.ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    correct, forbidden, port = json.loads(out.stdout.splitlines()[-1])
    assert correct and forbidden == [] and port


def test_the_reference_imports_nothing_of_the_program():
    for path in (core.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("tpu2048", "jax"):
            assert f"import {name}" not in text, path
            assert f"from {name}" not in text, path


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """Each cell at its own size, a short window: correct, and the
    control in the program's place is not."""
    _card()
    line = harness.run_cell(core.Cell(name), SEED, 5.0, False, "cuda",
                            control=True)
    assert line["correct"], line["checks"]
    assert not core.passes([(k, c["value"], c["limit"])
                            for k, c in line["control"].items()])
