"""The port's spans: :func:`tpu2048_torch.metrics.profiling.annotate` is
free with no profiler active and a ``torch.profiler`` user annotation under
one; the tabular trainer, the DQN trainer's learner, greedy eval and the
game session enter theirs once a step, an update or a move, inside their
parent's range; and a profiled chunk or vector step leaves the same state
as one without the profiler, bit for bit."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.env import fast as tfast
from tpu2048_torch.env.env import SHAPED, SIMPLE, EnvConfig
from tpu2048_torch.eval import demo as tdemo
from tpu2048_torch.eval import evaluate as tev
from tpu2048_torch.metrics import profiling
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.models import dqn as tmodel
from tpu2048_torch.training import dqn as tdtrain
from tpu2048_torch.training import tabular as tttrain

NARROW = dict(features=8, hidden=8, num_blocks=1, bf16=False, dropout=0.5,
              memory_size=256)
TABULAR = ("tabular.act", "tabular.env_step", "tabular.learn",
           "tabular.record")
LEARNER = ("learner.sample", "learner.forward", "learner.backward",
           "learner.optimizer")


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` on the CPU: its result and the
    user annotations recorded, as ``{name: [(start, end), ...]}``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.events():
        if e.is_user_annotation:
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, spans


def _inside(spans, names, parent):
    """Every range of ``names`` lies inside one of ``parent``'s."""
    for name in names:
        for a, b in spans[name]:
            assert any(p <= a and b <= q for p, q in spans[parent]), name


def _equal(a, b, path=""):
    """Two states (dataclasses, dicts, sequences, tensors, numbers) hold
    the same values, bit for bit."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            _equal(u, v, f"{path}/{i}")
    elif isinstance(a, (int, float, bool, str, type(None))):
        assert a == b, path


def _enter(name):
    with annotate(name):
        torch.ones(4).add_(1)


def test_annotate_is_free_without_a_profiler_and_a_span_under_one():
    off = annotate("tabular.act")
    assert off is annotate("learner") is profiling._NO_SPAN
    _enter("my.span")  # no profiler: nothing to record, nothing raised
    _, spans = _profiled(lambda: _enter("my.span"))
    assert len(spans["my.span"]) == 1
    assert annotate("my.span") is off  # off again once the profiler ends


# -- the tabular trainer --------------------------------------------------

def _tabular(backend, steps=3):
    config = tttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(capacity_log2=10),
        env=EnvConfig(reward=SHAPED), batch_size=16, steps_per_chunk=steps,
        engine="fast", table_backend=backend)
    bits, draws = tttrain.sources(7, "cpu")
    return config, tttrain.init_train_state(config, bits), bits, draws


@pytest.mark.parametrize("backend", ["auto", "legacy"])
def test_tabular_chunk_enters_its_spans_once_a_step(backend):
    config, st, bits, draws = _tabular(backend)

    def chunk():
        with annotate("chunk"):
            return tttrain.train_chunk(config, st, bits, draws)

    _, spans = _profiled(chunk)
    for name in TABULAR:
        assert len(spans[name]) == config.steps_per_chunk, name
    _inside(spans, TABULAR, "chunk")
    # The four parts follow each other, a step at a time.
    starts = sorted((a, n) for n in TABULAR for a, _ in spans[n])
    assert [n for _, n in starts] == list(TABULAR) * config.steps_per_chunk


@pytest.mark.parametrize("backend", ["auto", "legacy"])
def test_tabular_chunk_is_the_same_under_the_profiler(backend):
    config, plain, bits, draws = _tabular(backend)
    plain, eps = tttrain.train_chunk(config, plain, bits, draws)
    config, st, bits, draws = _tabular(backend)
    (traced, traced_eps), _ = _profiled(
        lambda: tttrain.train_chunk(config, st, bits, draws))
    _equal(traced, plain)
    assert torch.equal(traced_eps, eps)


# -- the DQN trainer's learner --------------------------------------------

def _dqn():
    config = tdtrain.DQNTrainConfig(
        agent=tdqn.DQNConfig(**NARROW), env=EnvConfig(reward=SIMPLE),
        num_envs=16, train_batch=8, steps_per_chunk=1, updates_per_step=2,
        seed=11)
    return config, tdtrain.init_loop_state(config, "cpu")


def test_dqn_vector_step_enters_the_learner_spans_once_an_update():
    config, st = _dqn()
    _, spans = _profiled(lambda: tdtrain.train_chunk(config, st))
    assert st.agent.train_steps == 2
    for name in ("actor", "env_step", "replay_add", "learner"):
        assert len(spans[name]) == 1, name
    for name in LEARNER:
        assert len(spans[name]) == 2, name
    _inside(spans, LEARNER, "learner")


def test_dqn_vector_step_is_the_same_under_the_profiler():
    config, plain = _dqn()
    tdtrain.train_chunk(config, plain)
    config, st = _dqn()
    _profiled(lambda: tdtrain.train_chunk(config, st))
    assert st.agent.train_steps == plain.agent.train_steps == 2
    _equal(st.state_dict(), plain.state_dict())


# -- greedy eval and model play -------------------------------------------

def _greedy():
    model = tmodel.create_model(tdqn.DQNConfig(**NARROW), "cpu").eval()
    return tev.greedy_dqn_policy(model)


def test_greedy_eval_enters_its_spans_once_a_step():
    policy = _greedy()
    env = EnvConfig(reward=SIMPLE, auto_reset=False)
    bits = tfast.GeneratorBits(3, "cpu")

    def call():
        with annotate("evaluate"):
            return tev.evaluate(policy, 4, bits, env, 4, 64, engine="fast")

    res, spans = _profiled(call)
    for name in ("eval.policy", "eval.env_step"):
        assert len(spans[name]) == res.batch_steps, name
    _inside(spans, ("eval.policy", "eval.env_step"), "evaluate")


def test_model_play_enters_its_spans_once_a_move():
    session = tdemo.GameSession(mode="model", policy=_greedy(), seed=5,
                                device="cpu")

    def moves():
        for _ in range(4):
            with annotate("move"):
                session.step_auto()

    _, spans = _profiled(moves)
    names = ("play.policy", "play.env_step", "play.read")
    for name in names:
        assert len(spans[name]) == 4, name
    _inside(spans, names, "move")
    assert session.moves == 4
