"""A lane trainer's chunk of steps as replays of one step captured in a
CUDA graph, shared by :mod:`tpu2048_torch.training.tabular` and
:mod:`tpu2048_torch.training.ntuple`.

The first chunk of a key runs one step eagerly (the kernels' builds and
loads, their shared-memory opt-in, happen outside the capture), captures
one step, and replays it for the rest; a later chunk of the same key only
replays. The graph reads and writes static copies of the state's tensors
(the step's outputs are copied back into them inside the graph); what the
step updates in place (the table, the weights) it updates in place. The
generators of the bit and draw sources are registered with the graph, so a
replay draws what an eager step would and leaves each generator where an
eager step would.

A trainer names its state's tensors: ``tensors(state)`` gives them by name
and ``rebuild(tensors)`` the state of such a dict. A name that
``tensors`` leaves out of a state (an output that no step reads) keeps the
static copy's value.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import torch

from tpu2048_torch.metrics.profiling import annotate


class StepGraphs:
    """The last step captured by one trainer, and how its chunks ran.

    ``counter`` carries the trainer's counts ``eager_steps``,
    ``graph_steps`` and ``captures`` (its ``train_chunk``); ``counted``
    are the kernel wrappers whose ``.launches`` count a step's launches:
    a replay adds the launches its capture counted, so that they keep
    counting on the card. ``span`` is the profiler span of a replayed
    step."""

    def __init__(self, counter, counted: Sequence[Any], span: str):
        self.counter = counter
        self.counted = tuple(counted)
        self.span = span
        self.last: Optional[_Graph] = None

    def chunk(self, steps: int, state, step: Callable, graphed: bool,
              key: Hashable = None, tensors: Callable = None,
              rebuild: Callable = None,
              generators: Sequence[torch.Generator] = (), device=None):
        """Run ``steps`` steps of ``step`` (state to state) from ``state``.
        With ``graphed`` false every step is eager; else the steps replay
        the graph of ``key``, captured on ``device`` after one eager step
        where the last graph has another key."""
        graph = None
        if graphed and self.last is not None and self.last.key == key:
            graph = self.last
        eager = 0 if graph is not None else (min(steps, 1) if graphed
                                             else steps)
        for _ in range(eager):
            state = step(state)
        self.counter.eager_steps += eager
        if eager == steps:
            return state
        if graph is None:
            self.last = None  # free the old graph's memory before capturing
            self.last = graph = _Graph(self, key, step, state, tensors,
                                       rebuild, generators, device)
            self.counter.captures += 1
        return graph.run(state, steps - eager)


class _Graph:
    """One step captured in a CUDA graph, keyed by what it captured."""

    def __init__(self, owner: StepGraphs, key, step, state, tensors,
                 rebuild, generators, device):
        self.owner, self.key = owner, key
        self.tensors, self.rebuild = tensors, rebuild
        self.generators = tuple(generators)  # keeps the keyed ones alive
        self.static = {k: torch.empty_like(t)
                       for k, t in tensors(state).items()}
        self.handed: Dict[str, tuple] = {}
        self.graph = torch.cuda.CUDAGraph()
        counted = owner.counted
        before = [fn.launches for fn in counted]
        with torch.cuda.device(device):
            for generator in self.generators:
                self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream()):
                out = step(rebuild(self.static))
                for k, t in tensors(out).items():
                    if t is not self.static[k]:
                        self.static[k].copy_(t)
        # The capture ran nothing: its counts become each replay's.
        self.launches = [fn.launches - n for fn, n in zip(counted, before)]
        for fn, n in zip(counted, before):
            fn.launches = n

    def run(self, state, steps: int):
        """Copy in the tensors of ``state`` that differ from the static
        ones (those this graph handed out last, unchanged since, do not),
        replay ``steps`` steps, and hand out copies."""
        for k, t in self.tensors(state).items():
            handed = self.handed.get(k)
            if (handed is None or handed[0] is not t
                    or handed[1] != t._version):
                self.static[k].copy_(t)
        for _ in range(steps):
            with annotate(self.owner.span):
                self.graph.replay()
        for fn, n in zip(self.owner.counted, self.launches):
            fn.launches += n * steps
        self.owner.counter.graph_steps += steps
        fresh = {k: t.clone() for k, t in self.static.items()}
        self.handed = {k: (t, t._version) for k, t in fresh.items()}
        return self.rebuild(fresh)
