"""Host launches of the n-tuple trainer's ``ntuple.step`` span a step: the
CUDA launches, copies and fills the host issued inside it, over the steps
of the traced part. A replayed step is one graph launch; the traced part
starts with one eager step, whose launches count too. A count, which the
host's speed does not move; None where the trace holds no launch (no
card)."""

from benchmark.counts import launches as L


def read(s):
    n = s.counts.get("steps", 0)
    ranges = s.spans.get("ntuple.step")
    calls = L.host_launches(s)
    if not n or not ranges or not calls or "legal_moves" not in s.counts:
        return None
    return len(L.launched_in(ranges, calls)) / n
