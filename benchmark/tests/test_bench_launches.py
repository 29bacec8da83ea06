"""Host launches and device time attributed to spans, on synthetic event
sets shaped as ``torch.profiler``'s events: a launch counts for the span it
starts in whatever host thread made it, a device operation's time goes to
the span of the launch that shares its correlation id, and the launches
inside the spans and outside them make up all of them."""

from types import SimpleNamespace

import torch
from torch.autograd import DeviceType

from benchmark import core
from benchmark.counts import launches as L
from benchmark.trace import Summary, Tracer

LEARNER = core.load_module(core.BENCH / "metrics"
                           / "learner.host_launches_per_update.py")


def _event(name, start, end, device=DeviceType.CPU, corr=0, thread=1,
           annotation=False):
    return SimpleNamespace(name=name, id=corr, thread=thread,
                           device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _summary(events, spans, **counts):
    counts = dict(dict(plain_s=1.0, plain_pace=1, pace=1), **counts)
    return Summary(_Prof(events), 1.0, spans, counts)


def _learner_trace():
    """Two updates' ``learner`` ranges; launches inside them on the main
    thread (1) and on autograd's (2), and outside them; aten ops and a
    kernel that are no launches."""
    return [
        _event("learner", 10, 20, annotation=True),
        _event("learner", 40, 50, annotation=True),
        _event("aten::mm", 11, 13),
        _event("cudaLaunchKernel", 12, 12.5, corr=101),
        _event("cudaLaunchKernel", 15, 15.5, corr=102, thread=2),
        _event("cudaMemcpyAsync", 19, 19.4, corr=103),
        _event("cudaGraphLaunch", 45, 46, corr=104, thread=2),
        _event("cudaLaunchKernel", 30, 30.5, corr=105),
        _event("cudaStreamSynchronize", 47, 49),
        _event("cudaLaunchKernel", 55, 55.5, corr=106),
        _event("gemm_kernel", 13, 18, DeviceType.CUDA, corr=101),
    ]


def test_a_launch_on_another_thread_counts_for_its_span():
    s = _summary(_learner_trace(), ("learner",), updates=2)
    # 101, 102 (autograd's thread) and 103 in the first update, 104 in
    # the second; 105 and 106 fall between and after.
    assert LEARNER.read(s) == 4 / 2
    assert LEARNER.read(_summary(_learner_trace(), ("learner",),
                                 updates=0)) is None


def test_device_time_goes_to_the_span_of_the_launch_with_its_id():
    launches = [(12, 101), (15, 102), (30, 105)]
    ops = [(101, 5.0), (102, 7.0), (102, 1.0), (105, 100.0), (999, 50.0)]
    inside = L.launched_in([(10, 20)], launches)
    # 105's kernel may run while the span is open; it was launched
    # outside it, so its time is not the span's. 102 is a graph of two.
    assert L.device_s(inside, ops) == 13.0 / 1e6
    assert L.device_s(L.launched_in([(25, 35)], launches), ops) == 100 / 1e6
    assert L.device_s([], ops) == 0.0


def test_launches_inside_the_spans_and_outside_make_up_all():
    events = _learner_trace()
    s = _summary(events, ("learner",), updates=2)
    calls = L.host_launches(s)
    assert len(calls) == sum(e.name in L.HOST_LAUNCHES for e in events) == 6
    spans = {"a": [(10, 20)], "b": [(40, 50), (44, 48)], "c": [(54, 56)]}
    counts = {k: len(L.launched_in(r, calls)) for k, r in spans.items()}
    # "b"'s second range lies inside its first: 104 counts once.
    assert counts == {"a": 3, "b": 1, "c": 1}
    outside = [t for t, _ in calls
               if not any(a <= t <= b for r in spans.values() for a, b in r)]
    assert outside == [30]
    assert sum(counts.values()) + len(outside) == len(calls)


def test_no_launches_on_the_cpu_read_none():
    tracer = Tracer(("learner",), "cpu")
    with tracer:
        with torch.profiler.record_function("learner"):
            torch.ones(8).add_(1)
    s = tracer.summary(dict(plain_s=1.0, plain_pace=1, pace=1, updates=1))
    assert s.spans["learner"] and L.host_launches(s) == []
    assert LEARNER.read(s) is None
