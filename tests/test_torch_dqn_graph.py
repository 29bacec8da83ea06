"""The DQN learner's update as a CUDA graph replay
(:func:`tpu2048_torch.agents.dqn.train_step`).

On the CPU: which path an update takes and why (``eager_reason``: the
device, a process group's ``grad_reduce``, a sliced module over two gloo
ranks), the counts a train state carries, what a capture is keyed on (the
shared rule of :mod:`tpu2048_torch.utils.cuda_graph`), and
the learning rate as a 0-d tensor written in place, whose state dict holds
a float, so that checkpoints of the float-lr optimizer still load.

On a CUDA card (skipped without one): graphed updates against eager ones.
Train states from the same weights, generator states and batches take the
same updates, one side forced eager by an identity ``grad_reduce``, the
other on the normal path, through an LR decay, a target sync, PER
priorities and a checkpoint round trip in mid-run (which recaptures). The
two sides' losses, |TD|, parameters, Adam's moments and steps, and the
dropout generator's state must be equal bit for bit where two eager runs
are; a second eager run shows whether they are.

This file imports nothing of JAX, so it runs on a machine with the card
and no JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_dqn_graph.py``.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.parallel import mesh, testkit
from tpu2048_torch.replay import buffer as replaylib
from tpu2048_torch.replay import sharded
from tpu2048_torch.training import dqn as ttrain
from tpu2048_torch.utils import cuda_graph

NARROW = dict(features=16, hidden=32, num_blocks=1, bf16=False, dropout=0.5,
              memory_size=256)
B = 8


def boards(gen, n, device="cpu"):
    return torch.randint(0, 12, (n, 4, 4), dtype=torch.int8, generator=gen,
                         device=device)


def batch_of(gen, n, device="cpu"):
    return {"board": boards(gen, n, device),
            "action": torch.randint(0, 4, (n,), generator=gen,
                                    device=device),
            "reward": torch.rand(n, generator=gen, device=device),
            "done": torch.rand(n, generator=gen, device=device) < 0.2,
            "next_board": boards(gen, n, device)}


def same_grad(parameters, loss):
    """A ``grad_reduce`` of one rank: the loss as it is."""
    return loss


def counts(state):
    learner = state.learner
    return (learner.eager_steps, learner.graph_steps, learner.captures,
            learner.eager_reason)


def key(cfg, st, batch):
    """The capture key of an update of ``st`` on ``batch``, as
    :func:`tpu2048_torch.agents.dqn.train_step` asks for it."""
    return cuda_graph.capture_key(cfg, batch, tdqn._keyed(st),
                                  (st.generator,))


def reload(state):
    """The agent through a checkpoint file and back (``_agent_dict`` out,
    ``torch.load`` on the CPU, ``_load_agent`` in), as a restore runs."""
    f = io.BytesIO()
    torch.save({"agent": ttrain._agent_dict(state)}, f)
    f.seek(0)
    ttrain._load_agent(state, torch.load(f, map_location="cpu",
                                         weights_only=True))


# -- the path an update takes (CPU) ----------------------------------------


def test_updates_off_the_card_or_under_a_process_group_run_eager():
    cfg = tdqn.DQNConfig(**NARROW)
    st = tdqn.create_train_state(cfg, "cpu", 0)
    gen = torch.Generator().manual_seed(1)
    assert counts(st) == (0, 0, 0, None)
    for _ in range(3):
        tdqn.train_step(cfg, st, batch_of(gen, B))
    assert counts(st) == (3, 0, 0, "device")
    assert st.learner.last is None and st.train_steps == 3
    tdqn.train_step(cfg, st, batch_of(gen, B), same_grad)
    assert counts(st) == (4, 0, 0, "process_group")
    assert tdqn.eager_reason(st) == "device"
    assert tdqn.eager_reason(st, same_grad) == "process_group"


def sliced_reasons():
    """On a rank of a ``(1, 2)`` grid: a sliced agent's reasons for one
    update without and one with a ``grad_reduce``, and its counts."""
    model_group, _ = mesh.grid_groups(1, 2)
    cfg = tdqn.DQNConfig(**dict(NARROW, dropout=0.0))
    st = tdqn.create_train_state(cfg, "cpu", 0, model_group)
    gen = torch.Generator().manual_seed(2)
    tdqn.train_step(cfg, st, batch_of(gen, B))
    first = st.learner.eager_reason
    tdqn.train_step(cfg, st, batch_of(gen, B), same_grad)
    return first, counts(st), sorted(st.model.sliced)


def test_a_sliced_module_runs_eager_over_its_model_group():
    ranks = testkit.spawn_ranks(2, functools.partial(sliced_reasons),
                                device="cpu", timeout_s=240)
    for first, (eager, graphed, captures, last), sliced in ranks:
        assert first == "model_group"
        assert (eager, graphed, captures, last) == (2, 0, 0,
                                                     "process_group")
        assert sliced  # the module holds slices


def test_the_capture_key_follows_what_a_captured_update_reads():
    cfg = tdqn.DQNConfig(**NARROW)
    st = tdqn.create_train_state(cfg, "cpu", 0)
    gen = torch.Generator().manual_seed(3)
    batch = batch_of(gen, B)
    tdqn.train_step(cfg, st, batch)  # Adam's state exists from here
    before = key(cfg, st, batch)
    # In place: an LR change, a decay, a target sync, another update.
    tdqn.set_lr(st, 1e-4)
    tdqn.maybe_decay_lr(cfg, st, 2)
    tdqn.update_target(st)
    tdqn.train_step(cfg, st, batch_of(gen, B))
    assert key(cfg, st, batch) == before
    # Another batch shape or dtype, another config, another generator.
    assert key(cfg, st, batch_of(gen, 2 * B)) != before
    assert key(cfg, st, dict(batch,
                             reward=batch["reward"].double())) != before
    assert key(dataclasses.replace(cfg, gamma=0.9), st, batch) != before
    other = dataclasses.replace(st, generator=torch.Generator())
    assert key(cfg, other, batch) != before
    # A restore replaces Adam's state and learning rate.
    reload(st)
    assert key(cfg, st, batch) != before
    before = key(cfg, st, batch)
    st.optimizer.load_state_dict(ttrain._clone(st.optimizer.state_dict()))
    assert key(cfg, st, batch) != before


# -- the learning rate (CPU) -----------------------------------------------


def test_the_learning_rate_is_a_float32_tensor_written_in_place():
    cfg = tdqn.DQNConfig(**NARROW)
    st = tdqn.create_train_state(cfg, "cpu", 0)
    group = st.optimizer.param_groups[0]
    lr = group["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    assert lr.dtype == torch.float32 and group["capturable"]
    assert group["fused"]
    got = tdqn.current_lr(st)
    assert type(got) is float and got == float(np.float32(5e-5))
    # The decay's float32 arithmetic, as the float-lr code computed it.
    f = np.float32
    want = f(cfg.learning_rate)
    for n in (1, 1, 3, 0, 7, 1, 40, 0, 2, 200, 0):
        tdqn.maybe_decay_lr(cfg, st, n)
        if n > 0:
            want = np.maximum(want * np.power(f(cfg.lr_decay_factor), f(n)),
                              f(cfg.lr_min))
        assert tdqn.current_lr(st) == float(want), n
        assert st.optimizer.param_groups[0]["lr"] is lr
    assert tdqn.current_lr(st) == float(np.float32(1e-6))
    tdqn.set_lr(st, 1e-7 / 3)
    assert tdqn.current_lr(st) == float(np.float32(1e-7 / 3))
    assert float(lr) == float(np.float32(1e-7 / 3))


def test_the_state_dict_holds_the_learning_rate_as_a_float():
    cfg = tdqn.DQNConfig(**NARROW)
    st = tdqn.create_train_state(cfg, "cpu", 0)
    gen = torch.Generator().manual_seed(4)
    tdqn.train_step(cfg, st, batch_of(gen, B))
    tdqn.set_lr(st, 3e-5)
    sd = st.optimizer.state_dict()
    assert type(sd["param_groups"][0]["lr"]) is float
    assert sd["param_groups"][0]["lr"] == float(np.float32(3e-5))
    assert isinstance(st.optimizer.param_groups[0]["lr"], torch.Tensor)
    twin = tdqn.create_train_state(cfg, "cpu", 1)
    twin.model.load_state_dict(st.model.state_dict())
    twin.optimizer.load_state_dict(ttrain._clone(sd))
    group = twin.optimizer.param_groups[0]
    assert isinstance(group["lr"], torch.Tensor) and group["capturable"]
    assert group["lr"].dtype == torch.float32
    assert tdqn.current_lr(twin) == tdqn.current_lr(st)


def test_a_checkpoint_of_the_float_lr_optimizer_loads_and_trains_alike():
    """An agent with the float-lr optimizer (``lr`` a float, not
    capturable: the checkpoints written before the rate became a tensor)
    is saved and restored into a fresh agent; the next update is the same
    on both, bit for bit."""
    cfg = tdqn.DQNConfig(**NARROW)
    old = tdqn.create_train_state(cfg, "cpu", 0)
    old.optimizer = torch.optim.Adam(
        old.model.parameters(), lr=float(np.float32(2e-5)),
        betas=(0.9, 0.999), eps=tdqn.ADAM_EPS, fused=True)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        tdqn.train_step(cfg, old, batch_of(gen, B))
    f = io.BytesIO()
    torch.save({"agent": ttrain._agent_dict(old)}, f)
    f.seek(0)
    payload = torch.load(f, map_location="cpu", weights_only=True)
    saved = payload["agent"]["optimizer"]["param_groups"][0]
    assert type(saved["lr"]) is float and not saved["capturable"]
    new = tdqn.create_train_state(cfg, "cpu", 1)
    ttrain._load_agent(new, payload)
    group = new.optimizer.param_groups[0]
    assert isinstance(group["lr"], torch.Tensor) and group["capturable"]
    assert tdqn.current_lr(new) == float(np.float32(2e-5))
    batch = batch_of(gen, B)
    loss_old, td_old = tdqn.train_step(cfg, old, batch)
    loss_new, td_new = tdqn.train_step(cfg, new, batch)
    assert torch.equal(loss_old, loss_new) and torch.equal(td_old, td_new)
    for p, q in zip(old.model.parameters(), new.model.parameters()):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(old.optimizer.state[p][k],
                               new.optimizer.state[q][k]), k


# -- graphed updates against eager ones (card) -----------------------------

CARD_UPDATES = 8
CASES = {
    "alpha0": dict(),
    "per": dict(alpha=0.6),
    "fused_conv": dict(fused_conv=True),
    "float32": dict(bf16=False),
}


class Side:
    """One train state with its own replay buffer and sampler generator,
    each from the same seeds as every other side's."""

    def __init__(self, cfg, device, grad_reduce=None):
        self.cfg, self.grad_reduce = cfg, grad_reduce
        self.state = tdqn.create_train_state(cfg, device, 7)
        fill = torch.Generator(device=device).manual_seed(8)
        n = 1024
        self.buffer = sharded.sharded_init(cfg.memory_size, 1, device)
        sharded.sharded_add(
            self.buffer, boards(fill, n, device),
            torch.randint(0, 4, (n,), generator=fill, device=device),
            torch.rand(n, generator=fill, device=device),
            torch.rand(n, generator=fill, device=device) < 0.1,
            boards(fill, n, device),
            torch.ones(n, dtype=torch.bool, device=device))
        self.sampler = torch.Generator(device=device).manual_seed(9)
        self.outputs = []

    def update(self):
        cfg = self.cfg
        indices = replaylib.sample_indices(self.buffer, cfg.batch_size,
                                           cfg.alpha, self.sampler)
        batch, indices, _ = sharded.sharded_sample(
            self.buffer, cfg.batch_size, cfg.alpha, cfg.beta, indices)
        loss, td = tdqn.train_step(cfg, self.state, batch, self.grad_reduce)
        if cfg.alpha != 0.0:
            sharded.sharded_update_priorities(self.buffer, indices, td,
                                              cfg.priority_epsilon)
        self.outputs.append((loss, td))

    def run(self, updates):
        """``updates`` updates with an LR decay after the second, a target
        sync after the third and a checkpoint round trip after the
        fifth."""
        for k in range(updates):
            self.update()
            if k == 1:
                tdqn.maybe_decay_lr(self.cfg, self.state, 3)
            if k == 2:
                tdqn.update_target(self.state)
            if k == 4:
                reload(self.state)
        torch.cuda.synchronize()
        return self

    def leaves(self):
        """Every number the updates leave, by name."""
        st = self.state
        out = {}
        for k, (loss, td) in enumerate(self.outputs):
            out[f"loss{k}"], out[f"td{k}"] = loss, td
        for name, p in st.model.named_parameters():
            out[name] = p.detach()
            for key, v in st.optimizer.state[p].items():
                out[f"{name}/{key}"] = v
        for name, p in st.target.named_parameters():
            out[f"target/{name}"] = p
        out["generator"] = st.generator.get_state()
        out["priority"] = self.buffer.priorities
        return out


def worst_gap(a, b):
    """The largest absolute difference of any leaf, and its name."""
    gaps = {k: float((a[k].double() - b[k].double()).abs().max())
            if a[k].is_floating_point() else float((a[k] != b[k]).sum())
            for k in a}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic
    implementations (warn where an op has none), restored after."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        flags[2:])


def graphed_against_eager(case):
    """Two eager runs and one graphed run of ``case``: the worst gap
    between the eager runs and between eager and graphed."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    cfg = tdqn.DQNConfig(memory_size=4096, **CASES[case])
    eager = Side(cfg, dev, same_grad).run(CARD_UPDATES)
    again = Side(cfg, dev, same_grad).run(CARD_UPDATES)
    graphed = Side(cfg, dev).run(CARD_UPDATES)
    # One eager update and a capture at the start and after the restore.
    assert counts(eager.state) == (CARD_UPDATES, 0, 0, "process_group")
    assert counts(graphed.state) == (2, CARD_UPDATES - 2, 2, None)
    spread, where = worst_gap(eager.leaves(), again.leaves())
    gap, at = worst_gap(eager.leaves(), graphed.leaves())
    print(f"{case}: two eager runs {spread:.3g} apart (at {where}), "
          f"graphed and eager {gap:.3g} (at {at})")
    return spread, where, gap, at


@pytest.mark.card
@pytest.mark.parametrize("case", ["alpha0", "fused_conv"])
def test_graphed_updates_equal_eager_updates(case):
    """The bf16 network as it trains: eager updates repeat bit for bit,
    and graphed ones equal them."""
    spread, where, gap, at = graphed_against_eager(case)
    assert spread == 0.0, f"eager updates not deterministic: {where}"
    assert gap == 0.0, at


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_updates_equal_eager_updates_deterministic(case,
                                                            deterministic):
    """Every case under deterministic algorithms. Without them two eager
    runs differ where float32 convolutions take cuDNN's weight-gradient
    kernels that add in no fixed order, and where PER writes the
    priorities of a slot sampled twice (``index_put_`` with repeated
    indices keeps either write); the graphed run differs from the eager
    runs as much as they differ from each other."""
    spread, where, gap, at = graphed_against_eager(case)
    assert spread == 0.0, f"eager updates not deterministic: {where}"
    assert gap == 0.0, at
