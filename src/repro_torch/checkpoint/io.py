"""Read the JAX package's flat-key ``.npz`` checkpoints (numpy only).

Keys encode the tree path as ``d:<name>`` (dict), ``l:<i>`` (list),
``t:<i>`` (tuple) or ``none:`` parts joined by ``||``; the structure is
rebuilt from the keys alone, so no pickle and no schema file.
"""
from __future__ import annotations

from typing import Any

import numpy as np

_SEP = "||"


def _assign(root, parts, value):
    key = parts[0]
    kind, _, name = key.partition(":")
    if kind == "none":
        return None
    if len(parts) == 1:
        if kind == "d":
            root[name] = value
        else:
            root.append(value)
        return root
    if kind == "d":
        child = root.setdefault(name, _container(parts[1]))
        if _assign(child, parts[1:], value) is None:
            root[name] = None
        return root
    idx = int(name)
    while len(root) <= idx:
        root.append(_container(parts[1]))
    if _assign(root[idx], parts[1:], value) is None:
        root[idx] = None
    return root


def _container(next_key: str):
    return {} if next_key.startswith("d:") else []


def load_pytree(path: str) -> Any:
    """Nested dicts/lists of numpy arrays from a ``save_pytree`` file."""
    with np.load(path, allow_pickle=False) as data:
        keys = sorted(data.files)
        root = _container(keys[0].split(_SEP)[0])
        for k in keys:
            _assign(root, k.split(_SEP), data[k])
    return root
