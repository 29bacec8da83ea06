"""DQN agent: actor and learner, the port of :mod:`tpu2048.agents.dqn`.

The agent is :class:`DQNTrainState` (online and target networks, an Adam
optimizer whose learning rate is changed in place, the epsilon step
counter, the update count and the learner's dropout generator) and
functions over it:

* :func:`select_actions`: batched epsilon-greedy action choice (Dqn8:312-
  324) with the driver's ``act_ripetitive`` override (mainDQL:176-185):
  lanes whose previous transition was a dedup skip act with the legal-move
  restriction. Its random draws are passed in (``SelectDraws``), from a
  draw source: :class:`GeneratorDraws` in production, the tests' own
  sources (JAX's draws) in the parity tests.
* :func:`train_step`: one ``replay`` update (Dqn8:351-400): online forward
  in train mode (dropout from the learner's generator), target forward,
  vanilla-DQN targets, MSE over the taken actions scaled 1/4, one Adam
  step; returns the loss and the per-sample |TD|. On the card, after one
  eager update, it captures one whole update in a CUDA graph and replays
  it for every later update of the train state (:class:`Learner`);
  :func:`eager_reason` says where it stays eager.
* :func:`epsilon_value` and :func:`maybe_decay_lr` follow the JAX
  package's float32 arithmetic on the host: the step counter and the update
  count are host integers, and the learning rate is a float32 value, a 0-d
  tensor on the parameters' device in Adam's parameter groups, written in
  place after each change so that a captured update reads the new value.
* :func:`dedup_mask`: ``remember``'s skip rule (Dqn8:280-297) on per-env
  caches of the last two saved transitions.

A draw source has two methods: ``select(b)`` returns ``(explore_u (B,)
f32, rand_any (B,) int32, legal_u (B,) f32)`` on the device of the boards,
and ``indices(buffer, batch, alpha)`` returns ``(batch,)`` slots of the
buffer to sample (``(S, batch/S)`` of a sharded buffer's shards from
:class:`ShardedDraws`, one source a shard).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu2048_torch.agents.tabular import _first_true
from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.models import dqn as dqn_model
from tpu2048_torch.parallel import mesh
from tpu2048_torch.parallel.mesh import ShardedSource
from tpu2048_torch.replay import buffer as replaylib
from tpu2048_torch.replay import sharded

ADAM_EPS = 1e-7  # keras Adam's epsilon, which the reference compiles with
SelectDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Hyperparameters; defaults = the run of record (Dqn8:249, Dqn8:203)."""

    gamma: float = 0.99
    epsilon: float = 0.9
    epsilon_min: float = 0.001
    epsilon_decay: float = 0.9999
    decay_episodes: int = 200  # kept for config parity (epsilon_decay1)
    batch_size: int = 64
    memory_size: int = 50_000
    alpha: float = 0.0
    beta: float = 1.0
    beta_increment: float = 1e-5
    learning_rate: float = 5e-5
    lr_decay_factor: float = 0.98  # Dqn8:302
    lr_min: float = 1e-6
    lr_decay_tile: int = 1024  # remember() arms the hook at >=1024 (Dqn8:284)
    priority_epsilon: float = 1e-6  # Dqn8:97
    dedup: bool = True
    # Network (Dqn8:209-246).
    features: int = 2048
    hidden: int = 1024
    dropout: float = 0.5
    num_blocks: int = 3
    bf16: bool = True
    fused_conv: bool = False  # one 4x4 conv a block (models/dqn.py)


class Learner:
    """How a train state's updates ran: the counts ``eager_updates``,
    ``graph_updates`` and ``captures``, the last update's ``eager_reason``
    (None where it captured or replayed), and the last update captured."""

    def __init__(self):
        self.eager_updates = self.graph_updates = self.captures = 0
        self.eager_reason: Optional[str] = None
        self.graph: Optional[_UpdateGraph] = None


@dataclasses.dataclass
class DQNTrainState:
    model: dqn_model.DQNCNN  # online network
    target: dqn_model.DQNCNN  # target network, no gradients
    optimizer: torch.optim.Adam
    step_counter: int  # epsilon decay steps (act calls)
    train_steps: int  # gradient updates taken
    generator: torch.Generator  # the learner's dropout masks
    learner: Learner = dataclasses.field(default_factory=Learner)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _lr_tensor(lr, device) -> torch.Tensor:
    return torch.tensor(_f32(lr), dtype=torch.float32, device=device)


def _lr_to_float(optimizer, state_dict: Dict) -> Dict:
    """A state dict's learning rates as Python floats, as checkpoints hold
    them."""
    state_dict["param_groups"] = [dict(g, lr=float(g["lr"]))
                                  for g in state_dict["param_groups"]]
    return state_dict


def _lr_to_tensor(optimizer) -> None:
    """After a load (a checkpoint holds a float): each group's learning
    rate a 0-d float32 tensor on its parameters' device, and capturable."""
    for group in optimizer.param_groups:
        group["lr"] = _lr_tensor(float(group["lr"]),
                                 group["params"][0].device)
        group["capturable"] = True


def make_optimizer(config: DQNConfig, model: torch.nn.Module
                   ) -> torch.optim.Adam:
    """Adam at the config's learning rate (rounded to float32), eps=1e-7:
    the reference compiles keras Adam with defaults (Dqn8:229), whose
    epsilon is 1e-7. One fused update a step, capturable, the learning rate
    a 0-d tensor on the parameters' device; its state dict holds the rate
    as a float, and a loaded one (a float or a tensor) becomes the tensor
    again."""
    device = next(model.parameters()).device
    optimizer = torch.optim.Adam(
        model.parameters(), lr=_lr_tensor(config.learning_rate, device),
        betas=(0.9, 0.999), eps=ADAM_EPS, fused=True, capturable=True)
    optimizer.register_state_dict_post_hook(_lr_to_float)
    optimizer.register_load_state_dict_post_hook(_lr_to_tensor)
    return optimizer


def create_train_state(config: DQNConfig, device, seed: int,
                       model_group: Optional[mesh.ModelGroup] = None
                       ) -> DQNTrainState:
    """Fresh networks on ``device`` with lecun-normal weights drawn from
    ``seed``, the target a copy of the online network. In a process group
    rank 0's weights are broadcast to every rank; with a ``model_group``
    both networks then keep this rank's slices (:func:`tpu2048_torch.
    models.dqn.shard_module`), and Adam's moments are made for the
    slices."""
    init_seed, learner_seed = np.random.SeedSequence(seed).generate_state(2)
    model = dqn_model.create_model(config, device)
    device = next(model.parameters()).device
    dqn_model.init_params(
        model, torch.Generator(device=device).manual_seed(int(init_seed)))
    mesh.broadcast_module(model)
    target = copy.deepcopy(model).eval().requires_grad_(False)
    dqn_model.shard_module(model, model_group)
    dqn_model.shard_module(target, model_group)
    return DQNTrainState(
        model=model,
        target=target,
        optimizer=make_optimizer(config, model),
        step_counter=0,
        train_steps=0,
        generator=torch.Generator(device=device).manual_seed(
            int(learner_seed)),
    )


def current_lr(state: DQNTrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: DQNTrainState, lr) -> DQNTrainState:
    """The learning rate, rounded to float32, written in place."""
    for group in state.optimizer.param_groups:
        group["lr"].fill_(_f32(lr))
    return state


def maybe_decay_lr(config: DQNConfig, state: DQNTrainState,
                   n: int) -> DQNTrainState:
    """LR <- max(lr * 0.98**n, 1e-6) in float32 for ``n`` qualifying
    episode ends (Dqn8:284-285, 299-309: once per episode that ended with a
    >= 1024 board). With ``n == 0`` the LR passes through untouched: only
    the decay path clamps at ``lr_min`` (Dqn8:303-306)."""
    if n > 0:
        f = np.float32
        lr = f(current_lr(state)) * np.power(f(config.lr_decay_factor), f(n))
        set_lr(state, np.maximum(lr, f(config.lr_min)))
    return state


def epsilon_value(config: DQNConfig, step_counter: int) -> float:
    """``max(eps_min, eps0 * decay**steps)`` in float32 (Dqn8:341-343)."""
    f = np.float32
    eps = f(config.epsilon) * np.power(f(config.epsilon_decay),
                                       f(step_counter))
    return float(np.maximum(f(config.epsilon_min), eps))


@torch.no_grad()
def update_target(state: DQNTrainState) -> DQNTrainState:
    """Hard sync (``update_target_model``, Dqn8:338-339)."""
    for t, p in zip(state.target.parameters(), state.model.parameters()):
        t.copy_(p)
    return state


class GeneratorDraws:
    """Draw source for production: ``torch.rand``/``torch.randint`` and
    :func:`tpu2048_torch.replay.buffer.sample_indices` from one
    ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def select(self, b: int) -> SelectDraws:
        kw = dict(generator=self.generator, device=self.device)
        return (torch.rand(b, **kw),
                torch.randint(0, 4, (b,), dtype=torch.int32, **kw),
                torch.rand(b, **kw))

    def indices(self, buffer, batch: int, alpha: float) -> torch.Tensor:
        return replaylib.sample_indices(buffer, batch, alpha, self.generator)


class ShardedDraws(ShardedSource):
    """Draw source of lane and replay shards: shard s draws the actor's
    draws of its lanes ``[s B/S, (s+1) B/S)`` and the ``batch/S`` sample
    indices of its replay shard from its own source (a
    :class:`GeneratorDraws` keyed by the shard). ``indices`` returns them as
    ``(S, batch/S)``."""

    def select(self, b: int) -> SelectDraws:
        parts = [src.select(self.per_shard(b)) for src in self.sources]
        return tuple(torch.cat(p) for p in zip(*parts))

    def indices(self, buffer, batch: int, alpha: float) -> torch.Tensor:
        s = len(self.sources)
        return torch.stack([
            src.indices(sharded.shard(buffer, i), batch // s, alpha)
            for i, src in enumerate(self.sources)])


def select_actions(model, boards, legal_mask, restrict_to_legal,
                   epsilon: float, draws: SelectDraws) -> torch.Tensor:
    """Batched epsilon-greedy action selection.

    Args:
      boards: (B, 4, 4) int8.
      legal_mask: (B, 4) bool, the legal moves of each board.
      restrict_to_legal: (B,) bool, lanes with ``act_ripetitive``
        semantics (the previous remember was a dedup skip).
      epsilon: the exploration rate, a float32 value.
      draws: ``(explore_u, rand_any, legal_u)`` as a draw source's
        ``select`` gives them.

    Returns:
      (B,) int32 actions.
    """
    explore_u, rand_any, legal_u = draws
    model.eval()
    with torch.no_grad():
        q = model(boards)

    # Greedy: plain argmax vs legal-restricted argmax (Dqn8:323,332-336).
    greedy_any = q.argmax(-1)
    has_legal = legal_mask.any(-1)
    greedy_legal = torch.where(
        has_legal, torch.where(legal_mask, q, -torch.inf).argmax(-1),
        greedy_any)
    greedy = torch.where(restrict_to_legal, greedy_legal, greedy_any)

    # Random: uniform over 4 vs uniform over the legal moves (Dqn8:319,328).
    legal_i = legal_mask.to(torch.int32)
    n_legal = legal_i.sum(-1)
    pick = torch.floor(legal_u * torch.clamp_min(n_legal, 1).to(
        torch.float32)).to(torch.int32)
    csum = torch.cumsum(legal_i, -1)
    rand_legal = _first_true((csum == pick[:, None] + 1) & legal_mask)
    rand_legal = torch.where(has_legal, rand_legal, rand_any)
    rand = torch.where(restrict_to_legal, rand_legal, rand_any)

    explore = explore_u < epsilon
    return torch.where(explore, rand, greedy).to(torch.int32)


@torch.no_grad()
def dqn_targets(config: DQNConfig, target, batch) -> torch.Tensor:
    """Vanilla-DQN targets (Dqn8:371-376)."""
    bootstrap = target(batch["next_board"]).amax(-1)
    return batch["reward"] + config.gamma * bootstrap * (
        1.0 - batch["done"].to(torch.float32))


def eager_reason(state: DQNTrainState, grad_reduce=None) -> Optional[str]:
    """Why :func:`train_step` runs an update eagerly, or None where it
    replays one captured update: ``"process_group"`` (a ``grad_reduce``:
    its collectives are not captured), ``"model_group"`` (a sliced module
    gathers over its model group in the forward and the backward) or
    ``"device"`` (the networks off the card)."""
    model = state.model
    if grad_reduce is not None:
        return "process_group"
    if model.model_group is not None or model.dense_group is not None:
        return "model_group"
    if not next(model.parameters()).is_cuda:
        return "device"
    return None


def train_step(config: DQNConfig, state: DQNTrainState, batch,
               grad_reduce=None):
    """One gradient update on a sampled batch (Dqn8:351-400), in place.

    With ``grad_reduce`` (data parallel: :func:`tpu2048_torch.parallel.
    mesh.average_gradients` over the data group), ``grad_reduce(parameters,
    loss)`` averages the gradients over the data-parallel ranks before Adam
    and returns the mean loss. A sliced module's backward sums the input
    gradients of its sliced layers over the model group itself, and the
    loss is the same on every model rank.

    Where :func:`eager_reason` finds nothing, the update replays the train
    state's captured one (:class:`_UpdateGraph`); the first update of a
    train state, and the first after its parameters, Adam's state or the
    batch's shapes change, runs eagerly and then captures. The counts of
    ``state.learner`` say which ran.
    Returns ``(loss, td_errors)``: the loss as a () tensor and the
    per-sample |TD| (B,), both without gradient.
    """
    learner = state.learner
    learner.eager_reason = reason = eager_reason(state, grad_reduce)
    graph = learner.graph
    if reason is None and graph is not None and graph.key == _graph_key(
            config, state, batch):
        out = graph.replay(batch)
        learner.graph_updates += 1
    else:
        learner.graph = None  # freed before an eager update or a capture
        out = _update(config, state, batch, grad_reduce)
        learner.eager_updates += 1
        if reason is None:
            learner.graph = _UpdateGraph(config, state, batch)
            learner.captures += 1
    state.train_steps += 1
    return out


def _update(config: DQNConfig, state: DQNTrainState, batch,
            grad_reduce=None):
    """The work of one update, eager or under capture: the loss and the
    per-sample |TD|."""
    with annotate("learner.forward"):
        targets = dqn_targets(config, state.target, batch)
        model = state.model
        model.train()
        q = model(batch["board"], generator=state.generator)
        q_taken = q.gather(1, batch["action"][:, None])[:, 0]
        # Only the taken-action cells carry the reference's full-matrix MSE
        # (tf.reduce_mean(square(targets - q_values)), Dqn8:371-380), so
        # the value and the gradient are the taken cells' MSE scaled 1/4.
        loss = ((targets - q_taken) ** 2).mean() / q.shape[-1]
    with annotate("learner.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with annotate("learner.optimizer"):
        if grad_reduce is not None:
            loss = grad_reduce(model.parameters(), loss)
        state.optimizer.step()
    return loss.detach(), (targets - q_taken.detach()).abs()


def _keyed(state: DQNTrainState) -> list:
    """The tensors a captured update reads in place: each parameter of
    both networks, each group's learning rate and each of Adam's state
    tensors."""
    opt = state.optimizer
    return [*state.model.parameters(), *state.target.parameters(),
            *(g["lr"] for g in opt.param_groups),
            *(t for st in opt.state.values() for t in st.values())]


def _graph_key(config: DQNConfig, state: DQNTrainState, batch) -> tuple:
    """What a captured update read: the config, the dropout generator,
    :func:`_keyed`'s tensors by identity and storage (a restore that
    replaces them needs a new capture, an in-place copy does not) and the
    batch's shapes and dtypes."""
    return (config, id(state.generator),
            tuple((id(t), t.data_ptr()) for t in _keyed(state)),
            tuple((k, v.shape, v.dtype) for k, v in batch.items()))


class _UpdateGraph:
    """One update of a train state captured in a CUDA graph: the target
    forward, the train-mode forward with its dropout, the loss, the
    backward and fused Adam's step. The graph reads the batch from static
    copies and updates the parameters, their gradients and Adam's moments
    and step in place; the dropout generator is registered with it, so a
    replay draws what an eager update would and leaves the generator where
    an eager update would."""

    def __init__(self, config: DQNConfig, state: DQNTrainState, batch):
        self.batch = {k: v.clone() for k, v in batch.items()}
        device = self.batch["board"].device
        # The eager update's gradients go; the capture allocates its own.
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            self.graph.register_generator_state(state.generator)
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream()):
                self.loss, self.td = _update(config, state, self.batch)
        # The graph holds what its key names, so that no id is reused.
        self.key = _graph_key(config, state, batch)
        self.held = (_keyed(state), state.generator)

    def replay(self, batch):
        """The update on ``batch``: its copies in, one replay, and copies of
        the loss and the |TD| out, which a later replay leaves alone."""
        for k, t in self.batch.items():
            t.copy_(batch[k])
        self.graph.replay()
        return self.loss.clone(), self.td.clone()


@torch.no_grad()
def load_jax_train_state(state: DQNTrainState, params, target_params, mu,
                         nu, count: int, lr, step_counter: int,
                         train_steps: int) -> DQNTrainState:
    """Carry a JAX train state into ``state``, in place: the flax parameter
    trees of both networks and Adam's moments ``mu``/``nu`` as numpy arrays
    (flax layout, whole), Adam's step ``count``, the learning rate and the
    two counters. A sliced agent loads its slices."""
    dqn_model.load_flax_params(state.model, params)
    dqn_model.load_flax_params(state.target, target_params)
    mus, nus = (dqn_model.slice_state_dict(
        state.model, dqn_model.flax_to_torch_layout(state.model, tree))
        for tree in (mu, nu))
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device),
            "exp_avg": mus[name].to(p.device, copy=True),
            "exp_avg_sq": nus[name].to(p.device, copy=True),
        }
    set_lr(state, lr)
    state.step_counter = int(step_counter)
    state.train_steps = int(train_steps)
    return state


# ---------------------------------------------------------------------------
# Transition dedup (remember, Dqn8:280-297)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DedupState:
    """Per-env cache of the last two SAVED (s, s') pairs."""

    s: torch.Tensor  # (B, 2, 4, 4) int8, slot 0 = most recent save
    ns: torch.Tensor  # (B, 2, 4, 4) int8
    saved_count: torch.Tensor  # (B,) int32
    last_saved: torch.Tensor  # (B,) bool, drives act_ripetitive next step


def dedup_init(batch_size: int, device="cpu") -> DedupState:
    return DedupState(
        s=torch.zeros((batch_size, 2, 4, 4), dtype=torch.int8, device=device),
        ns=torch.zeros((batch_size, 2, 4, 4), dtype=torch.int8,
                       device=device),
        saved_count=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
        last_saved=torch.ones((batch_size,), dtype=torch.bool, device=device),
    )


def dedup_mask(dd: DedupState, boards, next_boards, dones,
               enabled: bool = True) -> Tuple[torch.Tensor, DedupState]:
    """Which transitions to save, and the updated cache.

    Reference rule (Dqn8:283-297): always save the first 3 entries and all
    terminals; otherwise skip when (s, s') equals the entry two saves back
    (``get_third_last``, actually index nb_entries-2).
    """
    if not enabled:
        save = torch.ones_like(dones)
    else:
        is_equal = ((boards == dd.s[:, 1]).flatten(1).all(1)
                    & (next_boards == dd.ns[:, 1]).flatten(1).all(1))
        save = dones | ~is_equal | (dd.saved_count < 3)
    keep = save[:, None, None, None]
    new_dd = DedupState(
        s=torch.where(keep, torch.stack([boards, dd.s[:, 0]], 1), dd.s),
        ns=torch.where(keep, torch.stack([next_boards, dd.ns[:, 0]], 1),
                       dd.ns),
        saved_count=dd.saved_count + save.to(torch.int32),
        last_saved=save,
    )
    return save, new_dd
