"""The port's one CUDA-graph mechanism (:mod:`tpu2048_torch.utils.
cuda_graph`) on the CPU: its tree walk and its capture key, on the real
inputs of its three consumers: the tabular trainer's ``(state, eps)``
pair with the table's data read in place, the n-tuple trainer's state with
the network's weights read in place, and a DQN batch with the parameters,
learning rates and Adam's state of :func:`tpu2048_torch.agents.dqn._keyed`
read in place. And its eager path, which runs every step and asks for
nothing a capture reads.

Captures and replays need a card: ``tests/test_torch_dqn_graph.py``,
``tests/test_torch_tabular_graph.py`` and ``tests/test_torch_ntuple_graph.
py`` hold them to eager steps there.
"""

import dataclasses
import gc
import types

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.agents import ntuple as agent
from tpu2048_torch.agents.tabular import TabularConfig
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.env.env import SHAPED, EnvConfig
from tpu2048_torch.models.ntuple import NTupleNetwork
from tpu2048_torch.training import ntuple as ntrain
from tpu2048_torch.training import tabular as ttrain
from tpu2048_torch.utils import cuda_graph

B = 16
TINY = ((0, 1, 2), (4, 5, 9))
CONSUMERS = ("tabular", "ntuple", "dqn")


def tabular_case():
    config = ttrain.TabularTrainConfig(
        agent=TabularConfig(capacity_log2=10), env=EnvConfig(reward=SHAPED),
        batch_size=B, steps_per_chunk=2)
    bits, draws = ttrain.sources(0, "cpu")
    pair = ttrain.train_step(config, ttrain.init_train_state(config, bits),
                             bits, draws)
    return dict(
        key=(config.agent, config.env, config.batch_size),
        other_key=(dataclasses.replace(config.agent, learning_rate=0.2),
                   config.env, config.batch_size),
        tree=pair, inplace=lambda tree: [tree[0].table.data],
        generators=[bits.generator, draws.generator],
        write=lambda tree: ttrain.train_step(config, tree[0], bits, draws))


def ntuple_case():
    config = ntrain.NTupleTrainConfig(
        agent=agent.NTupleConfig(patterns=TINY), batch_size=B,
        steps_per_chunk=2)
    net = NTupleNetwork(TINY)
    bits = fastlib.GeneratorBits(0, "cpu")
    state = ntrain.train_step(config, net,
                              ntrain.init_train_state(config, bits), bits)
    return dict(
        key=(config.agent, config.batch_size),
        other_key=(dataclasses.replace(config.agent, alpha=0.2),
                   config.batch_size),
        tree=state, inplace=lambda tree: [net.weights],
        generators=[bits.generator],
        write=lambda tree: ntrain.train_step(config, net, tree, bits))


def dqn_case():
    config = tdqn.DQNConfig(features=16, hidden=32, num_blocks=1, bf16=False,
                            memory_size=256)
    st = tdqn.create_train_state(config, "cpu", 0)
    gen = torch.Generator().manual_seed(1)

    def batch():
        return {"board": torch.randint(0, 12, (B, 4, 4), dtype=torch.int8,
                                       generator=gen),
                "action": torch.randint(0, 4, (B,), generator=gen),
                "reward": torch.rand(B, generator=gen),
                "done": torch.rand(B, generator=gen) < 0.2,
                "next_board": torch.randint(0, 12, (B, 4, 4),
                                            dtype=torch.int8, generator=gen)}

    def write(tree):
        """An LR change, a target sync and another update, all in
        place."""
        tdqn.maybe_decay_lr(config, tdqn.set_lr(st, 1e-4), 2)
        tdqn.update_target(st)
        tdqn.train_step(config, st, batch())
        return tree

    first = batch()
    tdqn.train_step(config, st, first)  # Adam's state exists from here
    return dict(key=config, other_key=dataclasses.replace(config, gamma=0.9),
                tree=first, inplace=lambda tree: tdqn._keyed(st),
                generators=[st.generator], write=write)


@pytest.fixture(params=CONSUMERS)
def case(request):
    return types.SimpleNamespace(
        **{"tabular": tabular_case, "ntuple": ntuple_case,
           "dqn": dqn_case}[request.param]())


def key_of(case, tree, key=None, inplace=None, generators=None):
    return cuda_graph.capture_key(
        case.key if key is None else key, tree,
        case.inplace(tree) if inplace is None else inplace,
        case.generators if generators is None else generators)


def paths_of(case):
    return [p for p, t in cuda_graph.flatten(
        case.tree, case.inplace(case.tree))[1].items() if t is not None]


def with_leaf(case, path, leaf):
    """The case's tree with the tensor at ``path`` replaced by ``leaf``."""
    inplace = case.inplace(case.tree)
    spec, leaves = cuda_graph.flatten(case.tree, inplace)
    return cuda_graph.unflatten(spec, {**leaves, path: leaf}, inplace)


def test_flatten_and_unflatten_round_trip(case):
    inplace = case.inplace(case.tree)
    spec, leaves = cuda_graph.flatten(case.tree, inplace)
    tree = cuda_graph.unflatten(spec, leaves, inplace)
    assert type(tree) is type(case.tree)
    again, same = cuda_graph.flatten(tree, inplace)
    assert again == spec and same.keys() == leaves.keys()
    assert all(same[p] is t for p, t in leaves.items())
    assert len(leaves) >= 5


def test_in_place_tensors_are_left_out_of_the_copies(case):
    """A tree of the inputs and the in-place tensors themselves: no leaf
    is an in-place tensor, and the rebuilt tree holds each of them, not a
    copy."""
    inplace = case.inplace(case.tree)
    both = (case.tree, list(inplace))
    spec, leaves = cuda_graph.flatten(both, inplace)
    held = {id(t) for t in inplace}
    assert not any(id(t) in held for t in leaves.values())
    _, back = cuda_graph.unflatten(spec, leaves, inplace)
    assert all(a is b for a, b in zip(back, inplace))
    assert len(back) == len(inplace) > 0


def test_a_new_in_place_tensor_or_generator_gives_a_new_key(case):
    key = key_of(case, case.tree)
    assert key_of(case, case.tree) == key
    inplace = case.inplace(case.tree)
    for i, t in enumerate(inplace):
        assert key_of(case, case.tree, inplace=[
            t.clone() if j == i else u for j, u in enumerate(inplace)]) != key
    for i in range(len(case.generators)):
        generators = list(case.generators)
        generators[i] = torch.Generator()
        assert key_of(case, case.tree, generators=generators) != key


def test_an_input_shape_or_dtype_gives_a_new_key(case):
    key = key_of(case, case.tree)
    for path in paths_of(case):
        t = cuda_graph.flatten(case.tree, case.inplace(case.tree))[1][path]
        wider = with_leaf(case, path, t[None])
        other = with_leaf(case, path, t.to(
            torch.float64 if t.dtype != torch.float64 else torch.float32))
        assert key_of(case, wider) != key, path
        assert key_of(case, other) != key, path


def test_another_config_gives_a_new_key(case):
    assert key_of(case, case.tree, key=case.other_key) \
        != key_of(case, case.tree)


def test_an_in_place_write_keeps_the_key(case):
    key = key_of(case, case.tree)
    before = [t.clone() for t in case.inplace(case.tree)]
    tree = case.write(case.tree)
    after = case.inplace(tree)
    assert all(a is b for a, b in zip(after, case.inplace(case.tree)))
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert key_of(case, tree) == key


def test_an_eager_reason_runs_every_step_and_asks_for_nothing():
    counter = types.SimpleNamespace()
    graphs = cuda_graph.Graphs(counter)
    assert (counter.eager_steps, counter.graph_steps, counter.captures,
            counter.eager_reason) == (0, 0, 0, None)

    def never():
        raise AssertionError("asked for what a capture reads")

    out = graphs.run(lambda x: x + 1, torch.zeros(()), 5, "device",
                     inplace=never, generators=never, before_capture=never)
    assert int(out) == 5 and graphs.last is None
    assert (counter.eager_steps, counter.graph_steps, counter.captures,
            counter.eager_reason) == (5, 0, 0, "device")


def test_the_walk_leaves_no_reference_cycles(case):
    """A cycle would hold a call's tensors (on the card: a state copy a
    chunk) until the collector runs."""
    inplace = case.inplace(case.tree)
    gc.collect()
    gc.disable()
    try:
        spec, leaves = cuda_graph.flatten(case.tree, inplace)
        cuda_graph.unflatten(spec, leaves, inplace)
        cuda_graph.capture_key(case.key, case.tree, inplace, case.generators)
        del spec, leaves
        assert gc.collect() == 0
    finally:
        gc.enable()
