"""Batched prediction-tree state for dynamic batching (SpecPipe-DB): the
port of the JAX package's ``repro/core/dynbatch.py``.

The multi-request engine (``serving.dynbatch``) keeps every in-flight
request's dynamic prediction tree in one slot of a ``TreeBatch``: the
tree arrays stacked along a leading slot axis, with the per-slot counters
beside them.  Per-request operations (init on admission, expand on
proposal, prune-to-child on commit) are the ``core.tree`` functions
applied to one row and written back, so a request's tree trace is the
single-request engine's.

``deepest_layers`` gives every slot's entry layer stacked (tokens /
indices / validity / ancestor-mask rows, ``[slots, w, ...]``): the input
of the one fused tree verify per model per timestep.  Like ``core.tree``
the store is host state (CPU tensors and Python ints).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

_ARRAYS = ("tokens", "logprob", "parent", "depth", "mask")
_COUNTERS = ("n_nodes", "layer_start", "layer_size")


class TreeBatch:
    """Fixed-slot store of prediction trees stacked along axis 0."""

    def __init__(self, slots: int, capacity: int):
        if slots < 1 or capacity < 1:
            raise ValueError(f"need slots and capacity >= 1, got {slots}, "
                             f"{capacity}")
        self.slots, self.capacity = slots, capacity
        proto = tree_lib.tree_init(capacity, 0)
        self.arrays = {name: getattr(proto, name)[None].repeat(
            slots, *([1] * getattr(proto, name).dim())) for name in _ARRAYS}
        self.counters = {name: np.full(slots, getattr(proto, name), np.int64)
                         for name in _COUNTERS}
        self.active = np.zeros((slots,), bool)

    # -- row access -----------------------------------------------------
    def _check(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise IndexError(f"slot {slot} out of range")

    def get_row(self, slot: int) -> tree_lib.Tree:
        """Slot ``slot``'s tree (copies of its rows)."""
        self._check(slot)
        return tree_lib.Tree(
            *(self.arrays[name][slot].clone() for name in _ARRAYS),
            *(int(self.counters[name][slot]) for name in _COUNTERS))

    def set_row(self, slot: int, tree: tree_lib.Tree) -> None:
        """Store ``tree`` in slot ``slot``."""
        self._check(slot)
        for name in _ARRAYS:
            self.arrays[name][slot] = getattr(tree, name)
        for name in _COUNTERS:
            self.counters[name][slot] = getattr(tree, name)

    # -- per-request tree ops (core.tree on one row) ---------------------
    def init_row(self, slot: int, root_token: int) -> tree_lib.Tree:
        """Admission: a fresh single-root tree in ``slot``."""
        t = tree_lib.tree_init(self.capacity, root_token)
        self.adopt_row(slot, t)
        return t

    def adopt_row(self, slot: int, tree: tree_lib.Tree) -> None:
        """Admission of an already-built tree (the decode state's)."""
        if tree.capacity != self.capacity:
            raise ValueError(f"tree capacity {tree.capacity} != "
                             f"{self.capacity}")
        self.set_row(slot, tree)
        self.active[slot] = True

    def release_row(self, slot: int) -> None:
        """Retire: the slot may be recycled by the next admission."""
        self._check(slot)
        self.active[slot] = False

    def expand_row(self, slot: int, cand_tokens: torch.Tensor,
                   cand_logprobs: torch.Tensor, w: int) -> tree_lib.Tree:
        """``tree_expand`` on one slot's tree."""
        t = tree_lib.tree_expand(self.get_row(slot), cand_tokens,
                                 cand_logprobs, w)
        self.set_row(slot, t)
        return t

    def prune_row(self, slot: int,
                  child_idx: int) -> Tuple[tree_lib.Tree, torch.Tensor]:
        """Prune one slot's tree to a depth-1 child; returns (tree, old ->
        new index_map) for remapping the slot's in-flight state."""
        t, index_map = tree_lib.tree_prune_to_child(self.get_row(slot),
                                                    child_idx)
        self.set_row(slot, t)
        return t, index_map

    # -- stacked views ---------------------------------------------------
    def deepest_layers(self, w: int):
        """Every slot's entry layer, stacked: (tokens [S,w], idx [S,w],
        valid [S,w], mask_rows [S,w,N]).  Inactive slots still give rows
        (their stale trees); the fused dispatch masks them so they only
        ever write into their own slot's slack region."""
        ar = torch.arange(w)
        start = torch.as_tensor(self.counters["layer_start"])[:, None]
        size = torch.as_tensor(self.counters["layer_size"])[:, None]
        valid = ar[None] < size
        idx = torch.where(valid, start + ar[None], 0)
        tokens = torch.where(valid, torch.gather(self.arrays["tokens"], 1,
                                                 idx), 0).to(torch.int32)
        rows = torch.gather(self.arrays["mask"], 1, idx[..., None].expand(
            -1, -1, self.capacity))
        return tokens, idx, valid, rows & valid[..., None]

    def occupancy(self) -> int:
        """Slots holding an admitted request."""
        return int(self.active.sum())
