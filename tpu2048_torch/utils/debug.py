"""Debug-mode numerical checks, the port of :mod:`tpu2048.utils.debug`.

What remains worth guarding in the learner is its numerical health:
``checked(fn)`` runs ``fn`` and raises on the first NaN or Inf in its
floating-point outputs, so that a bad update fails loudly instead of
poisoning training. It reads the outputs on the host, so it is a debugging
tool: nothing on a hot path calls it.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


def _tensors(tree, path=""):
    """``(path, tensor)`` for each tensor of a nest of tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it raises FloatingPointError on the first NaN or
    Inf in a floating-point tensor it returns."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        for path, t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite value in "
                    f"output {path or '.'}")
        return out

    return wrapper
