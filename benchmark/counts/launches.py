"""Host launches: the CUDA runtime and driver calls that enqueue work on
the card (a kernel, a CUDA graph, an asynchronous copy or fill), as the
profiler names them, and their attribution to spans.

A span's host launches are those calls whose start lies inside one of its
ranges, on any host thread: autograd issues the backward's launches from
its own thread while the caller waits inside its span, so nesting by
thread would lose them. A span's device time is that of the operations
whose correlation id is one of its launches'. Both are counts of the
trace, not scaled to the untraced pace: the host's speed moves neither,
and the device time only a little.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple

from benchmark.trace import _merge

HOST_LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
    "cudaMemsetAsync"))

Launch = Tuple[float, int]  # (start, correlation id)


def launched_in(ranges: Iterable[Tuple[float, float]],
                launches: Iterable[Launch]) -> List[Launch]:
    """The ``launches`` whose start lies inside one of ``ranges`` (start,
    end), each once however many ranges hold it."""
    launches = sorted(launches)
    starts = [t for t, _ in launches]
    out: List[Launch] = []
    for a, b in _merge(ranges):
        out.extend(launches[bisect.bisect_left(starts, a):
                            bisect.bisect_right(starts, b)])
    return out


def device_s(launched: Iterable[Launch],
             device_ops: Iterable[Tuple[int, float]]) -> float:
    """Seconds of the device operations, (correlation id, microseconds),
    that the ``launched`` calls enqueued: a CUDA graph's launch enqueues
    many under one id."""
    ids = {c for _, c in launched}
    return sum(d for c, d in device_ops if c in ids) / 1e6


def host_launches(summary) -> List[Launch]:
    """The launches among a :class:`benchmark.trace.Summary`'s host
    operations. The summary keeps each operation's range and name, and
    no correlation id: the id given is 0."""
    return [(start, 0) for start, _, name in summary._cpu
            if name in HOST_LAUNCHES]
