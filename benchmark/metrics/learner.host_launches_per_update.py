"""Host launches of the trainer's ``learner`` span an update: the CUDA
launches, copies and fills the host issued inside it, on any thread (the
backward's come from autograd's), over the updates of the traced window.
A count, which the host's speed does not move and a CUDA graph of the
update cuts; None where the trace holds no launch (no card)."""

from benchmark.counts import launches as L


def read(s):
    n = s.counts.get("updates", 0)
    ranges = s.spans.get("learner")
    calls = L.host_launches(s)
    if not n or not ranges or not calls:
        return None
    return len(L.launched_in(ranges, calls)) / n
