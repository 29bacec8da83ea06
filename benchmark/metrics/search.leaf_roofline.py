"""The search kernels' share of their roofline in the traced call: the
least time of the trees of the counted steps (``counts/search_work.py``: 4
bytes a distinct weight read and the roots' boards and values at the HBM
rate, or 32 float32 adds a distinct leaf at 33.5e12 adds a second, whichever
is larger; the result line's ``window`` names the term) over those steps'
search kernels' device time. The counted steps are runs spread over the
whole call, so that their trees are the window's."""

from benchmark.counts import search_work as W


def read(s):
    c = s.counts
    if "search_ops" not in c:
        return None
    t = W.steps_time_s(s.kernels, c["search_steps"], c["pace"])
    least, _ = W.least_s(c["search_bytes"], c["search_ops"])
    return 100.0 * least / t if t else None
