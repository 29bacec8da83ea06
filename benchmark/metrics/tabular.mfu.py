"""The whole tabular step's share of the card's peak in the traced chunk:
the least time of the step's counted work (the step kernel's operations
at the integer peak, and the bucket kernels' bytes at the HBM rate,
whichever bounds), over the window. It bounds the kernels' rooflines: a
kernel taken off the path leaves its own share silent, not this one. The
window is its length without the profiler (:attr:`untraced_s`)."""

from benchmark.counts import kernels as K


def read(s):
    c = s.counts
    if "gathers" not in c or "sm_count" not in c:
        return None
    least = max(K.step_bound_s(c),
                K.bucket_bound_s(c["gathers"] + c["scatters"], c["lanes"]))
    return 100.0 * least / s.untraced_s
