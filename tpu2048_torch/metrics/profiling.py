"""Tracing and timing helpers, the port of :mod:`tpu2048.metrics.profiling`.

* :func:`trace`: a context manager around ``torch.profiler.profile`` (host
  and CUDA activity) that writes a Chrome trace into ``logdir`` and yields
  the profile, whose ``key_averages()`` and ``events()`` give the kernels.
* :func:`annotate`: the port's one span helper, a named host span on the
  profiler's timeline (``torch.profiler.record_function``) while a profiler
  is active, and a shared null context, which costs next to nothing,
  while none is. The trainers, the eval loop and the game session name
  their layers with it, a span a step, an update or a move.
* :func:`time_fn`: seconds a call, with the device synchronised before the
  first timed call and after the last, after warm-up calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the block (CPU and, where there is a card, CUDA activity);
    on exit write ``logdir/trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str) -> contextlib.AbstractContextManager:
    """A span named ``name``: ``record_function(name)`` while a profiler
    records, else one shared ``nullcontext``: a ``record_function``
    costs host time on entry and exit even where no profiler records it,
    and the hot loops enter their spans every step."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def _fence() -> None:
    """Wait for every queued kernel of the current CUDA device, if CUDA is
    in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 3, warmup: int = 1,
            **kw) -> float:
    """Run ``fn`` ``warmup`` times, then ``iters`` timed times between two
    device synchronisations; return seconds a call."""
    for _ in range(warmup):
        fn(*args, **kw)
    _fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _fence()
    return (time.perf_counter() - t0) / iters
