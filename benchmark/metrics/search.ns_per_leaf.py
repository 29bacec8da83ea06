"""Nanoseconds of the search kernels' device time a leaf that the program's
counter counted in the traced call, a whole call as the window plays them
(``ops/ntuple_kernel.py::leaf_counter``: a legal move at the last max layer
is one leaf)."""

from benchmark.counts import search_work as W


def read(s):
    leaves = s.counts.get("search_leaves")
    if not leaves:
        return None
    t = s.kernel_time_s(W.is_search)
    return 1e9 * t / leaves if t > 0 else None
