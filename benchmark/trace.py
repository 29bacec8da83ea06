"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over host and
CUDA activity, reduced in memory to what the per-layer readers take, and
to the breakdown of the result line. Nothing is written to disk.

A span is a host range named by ``record_function``: the trainer's own
scopes (``actor``, ``env_step``, ``replay_add``, ``learner``) and the
benchmark's, around each call it makes into the program (``bench.*``).
Device activity is every kernel, copy and fill on the card.

The profiler slows the host, and these paths wait on the host. So a traced
run first plays the same bounded part without the profiler and times it
(``plain_s``, over ``plain_pace`` units of the work that sets its pace:
updates, steps, batch steps or moves). A reader of a time or a share of the
window takes :attr:`Summary.untraced_s`, the traced work's seconds at the
untraced pace, and a span's time scaled to it (:meth:`Summary.plain_span_s`);
device times and counts are the trace's own.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
TOP = 10


def _merge(intervals: Iterable[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Summary:
    """The traced window in numbers. Times are microseconds on the
    profiler's clock; ``window_s`` is the host clock's."""

    def __init__(self, prof, window_s: float, span_names, counts: Dict):
        self.window_s = window_s
        self.counts = dict(counts)
        self.kernels: List[Tuple[str, float, float]] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            n: [] for n in span_names}
        cpu = []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CPU:
                if e.name in self.spans:
                    self.spans[e.name].append((start, end))
                elif not getattr(e, "is_user_annotation", False):
                    cpu.append((start, end, e.name))
            elif (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in self.spans and end > start):
                self.kernels.append((e.name, start, end - start))
        self._cpu = cpu
        self.busy = _merge((s, s + d) for _, s, d in self.kernels)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def kernel_time_s(self, match) -> float:
        """Seconds of device time of the kernels whose name ``match``
        accepts."""
        return sum(d for n, _, d in self.kernels if match(n)) / 1e6

    def kernel_count(self) -> int:
        """Kernels in the window, copies and fills left out."""
        return sum(1 for n, _, _ in self.kernels
                   if not n.startswith(("Memcpy", "Memset")))

    def span_s(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ())) / 1e6

    @property
    def untraced_s(self) -> Optional[float]:
        """Seconds the traced part's work takes without the profiler: the
        untraced part's seconds a unit of pace, times the traced units;
        None where either part did none of that work."""
        c = self.counts
        if not c["pace"] or not c["plain_pace"]:
            return None
        return c["plain_s"] * c["pace"] / c["plain_pace"]

    def plain_span_s(self, name: str) -> float:
        """A span's seconds scaled from the traced window to
        :attr:`untraced_s`: the span keeps its share of the window."""
        return self.span_s(name) * self.untraced_s / self.window_s

    def breakdown(self) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps of the device inside the window, each named by the spans and
        the innermost host operation that held it."""
        by_name: Dict[str, float] = {}
        for n, _, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        window = self.spans.get(WINDOW) or [(self.busy[0][0],
                                             self.busy[-1][1])]
        lo, hi = window[0][0], window[-1][1]
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        gaps = sorted(((max(a, lo), min(b, hi)) for a, b in
                       zip(edges[0::2], edges[1::2])
                       if min(b, hi) > max(a, lo)),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            held = sorted((s - e, n) for n, r in self.spans.items()
                          if n != WINDOW for s, e in r if s <= mid <= e)
            inner = [(e - s, n) for s, e, n in self._cpu if s <= mid <= e]
            names = [n for _, n in held] + [min(inner)[1] if inner
                                            else "host"]
            named.append(["/".join(names)[:120], (b - a) / 1e6])
        return {"device_ops": [[n[:120], d / 1e6] for n, d in ops],
                "idle_gaps": named}


class Tracer:
    """Profile a block: ``with Tracer(spans) as t: ...``, then
    ``t.summary(counts)``. The block runs inside the ``bench.window``
    span, and ends with a synchronise."""

    def __init__(self, span_names=(), device="cuda"):
        self.span_names = tuple(span_names) + (WINDOW,)
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, fn):
        """``fn()`` without the profiler, between two synchronises: its
        result and its seconds."""
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        return out, time.perf_counter() - t0

    def __enter__(self):
        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.rf = record_function(WINDOW)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self, counts: Dict) -> Summary:
        return Summary(self.prof, self.window_s, self.span_names, counts)
