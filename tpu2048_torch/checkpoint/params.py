"""Parameter files: the flax parameter tree as a numpy ``.npz``.

Keys are the flax names joined with ``/`` (``block0/conv1x1_kernel``,
``dense/kernel``, ...), so the JAX package's parameters can be written with
numpy alone and read by :func:`tpu2048_torch.models.dqn.load_flax_params`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _flatten(tree, prefix=""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _flatten(value, key + "/")
        else:
            yield key, np.asarray(value)


def save_params(path, params) -> None:
    """Write a nested dict of arrays to ``path`` as an ``.npz``."""
    np.savez(path, **dict(_flatten(params)))


def load_params(path) -> Dict:
    """Read an ``.npz`` written by :func:`save_params` as a nested dict."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
