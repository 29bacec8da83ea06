"""A step as replays of one capture in a CUDA graph: the port's one
capture, shared by the DQN learner's update (:mod:`tpu2048_torch.agents.
dqn`) and the lane trainers' steps (:mod:`tpu2048_torch.training.tabular`,
:mod:`tpu2048_torch.training.ntuple`).

With an eager reason every step runs eagerly. Else a call with the last
capture's :func:`capture_key` copies its inputs in, replays and hands out
copies; a call with another key frees the old graph, runs one step eagerly
(the kernels' builds and loads happen outside the capture), captures one
step and replays the rest.

Inputs and outputs are trees of dataclasses, tuples, lists and dicts of
tensors, which :func:`flatten` walks into paths and :func:`unflatten`
rebuilds. The tensors a step reads and writes in place (a table, weights, the
parameters and Adam's state) are no leaves: the graph uses them as they
are. It reads static copies of the other inputs; an output at an input's
path is copied into that input inside the graph (a None input is a slot
that the output fills), and the other outputs are the graph's own. A
tensor the graph handed out, unchanged since, is not copied in again. The
generators of the step's draws are registered with the graph, so a replay
draws what an eager step would and leaves each generator where it would.

The key is the consumer's config, the inputs' structure and each copied
input's shape and dtype, each in-place tensor's identity and storage and
each generator's identity; a capture holds those tensors and generators,
so that no identity is reused. The counts ``eager_steps``,
``graph_steps``, ``captures`` and the last call's ``eager_reason`` are
kept on the consumer's counter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from tpu2048_torch.metrics.profiling import annotate


def flatten(tree, inplace: Sequence[torch.Tensor] = ()):
    """``(spec, leaves)``: the structure of ``tree`` and its tensors and
    Nones by path (a tuple of field names, indices and keys). The spec
    holds a tensor of ``inplace`` by its index there, not as a leaf."""
    leaves: Dict[tuple, Optional[torch.Tensor]] = {}
    index = {id(t): i for i, t in enumerate(inplace)}
    return _walk(tree, (), index, leaves), leaves


# The walks are module functions, not closures: a closure that calls
# itself is a reference cycle, which would hold a call's tensors on the
# card until the collector runs.
def _walk(node, path, index, leaves):
    if isinstance(node, torch.Tensor) or node is None:
        i = index.get(id(node))
        if i is not None:
            return ("inplace", i)
        leaves[path] = node
        return _HOLE if node is None else _LEAF
    names = _fields(type(node))
    if names is not None:
        return (type(node), tuple([
            (n, _walk(getattr(node, n), path + (n,), index, leaves))
            for n in names]))
    if isinstance(node, (tuple, list, dict)):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        return (type(node), tuple([(k, _walk(v, path + (k,), index, leaves))
                                   for k, v in items]))
    return ("const", node)


_LEAF, _HOLE = ("leaf", False), ("leaf", True)


@functools.lru_cache(maxsize=None)
def _fields(cls) -> Optional[Tuple[str, ...]]:
    """A dataclass's field names (looked up once a class), else None."""
    if not dataclasses.is_dataclass(cls):
        return None
    return tuple(f.name for f in dataclasses.fields(cls))


def unflatten(spec, leaves: Dict[tuple, Optional[torch.Tensor]],
              inplace: Sequence[torch.Tensor] = ()):
    """The tree of :func:`flatten`'s ``spec``, its leaves from ``leaves``
    (None where the spec's leaf was None) and in-place tensors from
    ``inplace``."""
    return _build(spec, (), leaves, inplace)


def _build(node, path, leaves, inplace):
    kind, body = node
    if kind == "leaf":
        return None if body else leaves[path]
    if kind == "inplace":
        return inplace[body]
    if kind == "const":
        return body
    items = [(k, _build(v, path + (k,), leaves, inplace)) for k, v in body]
    if kind in (tuple, list):
        return kind(v for _, v in items)
    return kind(**dict(items)) if kind is not dict else dict(items)


def capture_key(config, inputs, inplace: Sequence[torch.Tensor] = (),
                generators: Sequence[torch.Generator] = ()) -> tuple:
    """What a capture of a step on ``inputs`` reads (the module's
    docstring)."""
    return _key(config, *flatten(inputs, inplace), inplace, generators)


def _key(config, spec, leaves, inplace, generators) -> tuple:
    return (config, spec,
            tuple([(t.shape, t.dtype) for t in leaves.values()
                   if t is not None]),
            tuple([(id(t), t.data_ptr()) for t in inplace]),
            tuple([id(g) for g in generators]))


class Graphs:
    """The last step a consumer captured, and how its calls ran.

    ``counter`` carries the counts (this instance where it is None);
    ``counted`` are the kernel wrappers whose ``.launches`` count a step's
    launches (a replay adds what its capture counted); ``span`` names the
    profiler span of a replayed step, if any."""

    def __init__(self, counter=None, counted: Sequence[Any] = (),
                 span: Optional[str] = None):
        self._counter = counter  # None: no reference cycle to this instance
        self.counted, self.span = tuple(counted), span
        self.last: Optional[_Graph] = None
        self.counter.eager_steps = self.counter.graph_steps = 0
        self.counter.captures, self.counter.eager_reason = 0, None

    @property
    def counter(self):
        return self if self._counter is None else self._counter

    def run(self, step: Callable, inputs, steps: int = 1,
            reason: Optional[str] = None, key=None,
            inplace: Callable[[], Sequence[torch.Tensor]] = tuple,
            generators: Callable[[], Sequence[torch.Generator]] = tuple,
            before_capture: Callable[[], None] = lambda: None):
        """``steps`` steps of ``step`` from ``inputs``, each on the last
        one's outputs: eager with a ``reason``, else replays of the capture
        of ``key`` (the consumer's config) and of what ``inplace()`` and
        ``generators()`` give. Those two are asked only here; a capture
        asks after its eager step, which may make what it reads (Adam's
        moments). ``before_capture`` runs just before a capture. Returns
        the last step's outputs."""
        counter = self.counter
        counter.eager_reason = reason
        graph = self.last if reason is None else None
        if graph is not None:
            now = tuple(inplace())
            spec, leaves = flatten(inputs, now)  # one walk a call
            if graph.key != _key(key, spec, leaves, now, generators()):
                graph = None
        if graph is None:
            self.last = None  # freed before an eager step or a capture
            eager = steps if reason is not None else 1
            out = inputs
            for _ in range(eager):
                out = step(out)
            counter.eager_steps += eager
            if reason is not None:
                return out
            self.last = graph = _Graph(self.counted, key, step, inputs, out,
                                       inplace(), generators(),
                                       before_capture)
            counter.captures += 1
            steps -= 1
            if not steps:
                return out
            leaves = flatten(out, graph.inplace)[1]
        return graph.replay(self, leaves, steps)


class _Graph:
    """One step captured in a CUDA graph, keyed by what it captured."""

    def __init__(self, counted, config, step, inputs, eager_out, inplace,
                 generators, before_capture):
        self.inplace, self.generators = tuple(inplace), tuple(generators)
        self.key = capture_key(config, inputs, self.inplace, self.generators)
        spec, leaves = flatten(inputs, self.inplace)
        filled = flatten(eager_out, self.inplace)[1]
        self.static = {p: torch.empty_like(t if t is not None else filled[p])
                       for p, t in leaves.items()
                       if t is not None or filled.get(p) is not None}
        self.handed: Dict[tuple, tuple] = {}
        device = (self.inplace + tuple(self.static.values()))[0].device
        before = [fn.launches for fn in counted]
        before_capture()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            for generator in self.generators:
                self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream()):
                out = step(unflatten(spec, self.static, self.inplace))
                self.out_spec, outs = flatten(out, self.inplace)
                for p, t in outs.items():
                    if p in self.static and t is not self.static[p]:
                        self.static[p].copy_(t)
        self.outputs = {p: self.static.get(p, t) for p, t in outs.items()}
        # The capture ran nothing: its counts become each replay's.
        self.launches = [fn.launches - n for fn, n in zip(counted, before)]
        for fn, n in zip(counted, before):
            fn.launches = n

    def replay(self, owner: Graphs, leaves, steps: int):
        """Copy in the input ``leaves`` that differ from the static ones
        (those this graph handed out last, unchanged since, do not),
        replay ``steps`` steps, count them on ``owner``, and hand out
        copies."""
        for p, t in leaves.items():
            handed = self.handed.get(p)
            if t is not None and (handed is None or handed[0] is not t
                                  or handed[1] != t._version):
                self.static[p].copy_(t)
        for _ in range(steps):
            with (annotate(owner.span) if owner.span is not None
                  else contextlib.nullcontext()):
                self.graph.replay()
        for fn, n in zip(owner.counted, self.launches):
            fn.launches += n * steps
        owner.counter.graph_steps += steps
        fresh = {p: t if t is None else t.clone()
                 for p, t in self.outputs.items()}
        self.handed = {p: (t, t._version) for p, t in fresh.items()
                       if p in self.static}
        return unflatten(self.out_spec, fresh, self.inplace)
