"""The JAX package's flat-key ``.npz`` checkpoints: a file either package
writes, the other reads.

Keys encode the tree path as ``d:<name>`` (dict), ``l:<i>`` (list),
``t:<i>`` (tuple) or ``none:`` parts joined by ``||``; the structure is
rebuilt from the keys alone, so no pickle and no schema file.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_SEP = "||"


def _flatten(tree: Any, prefix: str = "") -> dict:
    """Flat ``{key: array}`` of a tree of dicts, lists, tuples, None and
    arrays (torch tensors are copied to host numpy arrays)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}d:{k}" if prefix
                                else f"d:{k}"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{tag}:{i}" if prefix
                                else f"{tag}:{i}"))
    elif tree is None:
        out[prefix + _SEP + "none:" if prefix else "none:"] = np.zeros(0)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` as a flat-key ``.npz``."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


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
