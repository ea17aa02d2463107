"""Compute backends for SpecPipe-DB, the executor seam: the port of the
JAX package's ``repro/serving/executor.py`` (``PipelineExecutor`` and
``LocalFusedExecutor``).

The engine (``serving.dynbatch.SpecPipeDBEngine``) decides *what* every
request computes; an executor decides *where and how* a timestep's batched
work runs.  The seam is the batched dispatches of a global timestep plus
admission prefill:

  * ``verify_rows`` - ONE tree verify per model over every pending slot's
    deepest tree layer (per-row ``model_len``, ``tree_write_index``,
    ``tree_mask [B, n, Tcap]``);
  * ``commit_rows`` - the batched two-level cache sync at exit (tree row 0
    of every exiting slot moves into its model cache at ``model_len``);
  * ``remap_rows`` - the batched post-prune compaction of the pruned
    slots' tree caches (``remap_row`` is the one-slot reference);
  * ``prefill`` - the admission prefill of a request into its slot.

The executor owns the cache storage and the power-of-two slot-count
bucketing: a dispatch covers the smallest power-of-two prefix of slot
rows that spans every pending slot.

``LocalFusedExecutor`` is the single-device fused path over a
``KVArena``, or with ``paged=True`` over a ``PagedKVArena`` whose paged
leaves reach the layers as they are, so the tree verify runs the paged
kernels with no densification.  The sharded, overlapped and async
pipeline executors of the reference are not ported (``ROADMAP.md`` queue
1 item 11).

``calls`` counts ``verify_rows`` (one per timestep with pending entries),
``commit_rows`` and ``remap_rows``.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from repro_torch.core.speculative import ModelBundle
from repro_torch.models import transformer as tf
from repro_torch.serving.scheduler import KVArena, PagedKVArena, SlotPool


class PipelineExecutor:
    """The executor interface and the shared slot-count bucketing.

    Subclasses implement ``prefill`` / ``verify_rows`` / ``commit_rows`` /
    ``remap_row`` against their own storage and expose ``arena`` (a
    ``SlotPool``) for the scheduler's slot accounting."""

    slots: int
    arena: SlotPool
    overlapped = False

    def __init__(self, slots: int):
        self.slots = slots
        self.calls = collections.Counter()

    def _bucket(self, rows: int) -> int:
        """Smallest power-of-two prefix of slot rows spanning ``rows``
        rows (capped at ``slots``)."""
        b = 1
        while b < rows:
            b *= 2
        return min(b, self.slots)

    def _rows_on(self, row_on) -> int:
        return self._bucket(int(np.max(np.nonzero(np.asarray(row_on))[0]))
                            + 1)

    # -- interface -----------------------------------------------------
    def prefill(self, slot: int, prompt):
        """Fill both models' caches of ``slot`` from a [1, len] prompt;
        returns the target's last-position logits [1, V]."""
        raise NotImplementedError

    def verify_rows(self, tokens, positions, masks, model_len, write_idx,
                    row_on):
        """ONE tree verify per model over the bucketed prefix of slot rows.
        Inputs span every slot ([slots, ...]); returns (target logits
        [nb, w, V], draft logits [nb, w, V])."""
        raise NotImplementedError

    def commit_rows(self, model_len, commit_mask) -> None:
        """Batched two-level cache sync: every row with ``commit_mask``
        moves its tree row 0 into its model cache at its ``model_len``;
        the other rows stay bit-unchanged."""
        raise NotImplementedError

    def remap_row(self, slot: int, index_map) -> None:
        """Post-prune tree-cache compaction of one slot."""
        raise NotImplementedError

    def _draft_cache(self):
        raise NotImplementedError

    def _draft_tree(self):
        raise NotImplementedError

    def _draft_verify(self, tokens, positions, masks, model_len, write_idx,
                      row_on):
        """ONE bucketed draft tree verify over the entering slot rows (the
        draft proposes the next layer the same timestep).  Returns the
        draft logits and its tree caches."""
        nb = self._rows_on(row_on)
        d_all, d_tree = self.draft.tree_verify_rows(
            tokens[:nb], positions[:nb], masks[:nb], self._draft_cache(),
            model_len[:nb], self._draft_tree(), write_idx[:nb], bucket=nb)
        self.calls["verify_rows"] += 1
        return d_all, d_tree

    def remap_rows(self, index_maps, row_mask) -> None:
        """Batched exit-phase prune/remap: slot b's tree caches are
        compacted with ``index_maps[b]`` wherever ``row_mask[b]`` (the
        other rows of ``index_maps`` must be the identity).  This base
        version loops ``remap_row`` over the masked slots, the reference
        a backend's one batched gather is held to."""
        for slot in np.nonzero(np.asarray(row_mask))[0]:
            self.remap_row(int(slot), index_maps[int(slot)])


class LocalFusedExecutor(PipelineExecutor):
    """The fused single-device path: the slot-stacked ``KVArena`` is the
    storage and ``ModelBundle.tree_verify_rows`` / ``commit_rows`` are the
    dispatches.

    ``paged=True`` takes a ``PagedKVArena`` instead (``page`` rows per
    block; ``model_blocks``/``tree_blocks`` cap the pools; ``lazy_tree``
    backs the tree region on demand): the scheduler allocates, swaps and
    preempts blocks, and the dispatches pass the paged leaves to the
    layers, whose tree verify runs the paged kernels."""

    def __init__(self, target: ModelBundle, draft: ModelBundle, *,
                 slots: int, max_len: int, tree_capacity: int,
                 capacity: int, paged: bool = False, page: int = 16,
                 model_blocks: Optional[int] = None,
                 tree_blocks: Optional[int] = None,
                 lazy_tree: bool = False):
        super().__init__(slots)
        self.target, self.draft = target, draft
        self.capacity = capacity
        self.paged = bool(paged)
        if self.paged:
            self.arena = PagedKVArena(
                target, draft, slots=slots, max_len=max_len,
                tree_capacity=tree_capacity, page=page,
                model_blocks=model_blocks, tree_blocks=tree_blocks,
                lazy_tree=lazy_tree)
        else:
            self.arena = KVArena(target, draft, slots=slots,
                                 max_len=max_len,
                                 tree_capacity=tree_capacity)

    def prefill(self, slot: int, prompt):
        t_cache, d_cache, t_tree, d_tree = self.arena.caches(slot)
        t_logits, t_cache = self.target.prefill(prompt, t_cache)
        _, d_cache = self.draft.prefill(prompt, d_cache)
        self.arena.store(slot, (t_cache, d_cache, t_tree, d_tree))
        return t_logits

    def _draft_cache(self):
        return self.arena.stacked[1]

    def _draft_tree(self):
        return self.arena.stacked[3]

    def verify_rows(self, tokens, positions, masks, model_len, write_idx,
                    row_on):
        nb = self._rows_on(row_on)
        t_cache, _, t_tree, _ = self.arena.stacked
        v_all, _ = self.target.tree_verify_rows(
            tokens[:nb], positions[:nb], masks[:nb], t_cache, model_len[:nb],
            t_tree, write_idx[:nb], bucket=nb)
        d_all, _ = self._draft_verify(tokens, positions, masks, model_len,
                                      write_idx, row_on)
        return v_all, d_all

    def commit_rows(self, model_len, commit_mask) -> None:
        node0 = np.zeros((self.slots,), np.int32)   # row 0 is the root
        t_cache, d_cache, t_tree, d_tree = self.arena.stacked
        self.target.commit_rows(t_cache, t_tree, node0, model_len,
                                commit_mask)
        self.draft.commit_rows(d_cache, d_tree, node0, model_len,
                               commit_mask)
        self.calls["commit_rows"] += 1

    def remap_row(self, slot: int, index_map) -> None:
        imap = np.asarray(index_map, np.int32)[None]
        for tree in self.arena.stacked[2:]:
            tf.remap_tree_cache_rows(tf.slice_cache_rows(tree, slot, 1),
                                     imap)

    def remap_rows(self, index_maps, row_mask) -> None:
        """ONE batched gather per model over the slot-stacked tree arenas
        (identity rows leave the other slots bit-unchanged)."""
        if not np.any(np.asarray(row_mask)):
            return
        for tree in self.arena.stacked[2:]:
            tf.remap_tree_cache_rows(tree, index_maps)
        self.calls["remap_rows"] += 1
