"""Compute backends for SpecPipe-DB, the executor seam: the port of the
JAX package's ``repro/serving/executor.py`` (``PipelineExecutor``,
``LocalFusedExecutor``, ``ShardedPipelineExecutor``,
``OverlappedShardedExecutor`` and ``AsyncPipelineExecutor``).

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

Backends:

  * ``LocalFusedExecutor`` - the single-device fused path over a
    ``KVArena``, or with ``paged=True`` over a ``PagedKVArena`` whose paged
    leaves reach the layers as they are, so the tree verify runs the paged
    kernels with no densification.
  * ``ShardedPipelineExecutor`` - the paper's pipelined deployment, flush
    schedule: the target's layers are cut into ``n_stages`` stages
    (``launch.pipeline``) and each timestep's verify pushes the bucketed
    entry layer around the stage ring in exactly ``n_stages`` ticks
    (``make_pipeline_verify``), so its logits exist at the entry
    timestep and every output equals the local backend's.  The draft runs
    beside stage 0 through the local fused path (it proposes the next
    layer the same timestep, so it cannot ride the ring).
  * ``OverlappedShardedExecutor`` - the same deployment in the paper's
    steady state: the ring persists across timesteps and each timestep is
    ONE tick.  Verify logits exist only when a layer exits
    (``t + n_stages - 1``), so ``tick_rows`` returns ``Deferred``
    futures that the engine's flights resolve at exit;
    commits and prunes enter the ring as the next tick's ctrl message
    (pruning propagation); misses and retires ``kill`` the slot's
    in-flight layers; admission prefills stream through the ring's
    prefill lane (``begin_prefill``, ``PREFILL_LANE``-token chunks).
    Committed tokens equal the flush
    backend's: only *when* logits materialise changes.
  * ``AsyncPipelineExecutor`` - the host lockstep broken: one free-running
    actor thread per stage pulls messages (tree layers, ctrl, admission
    scatters) from a bounded inbox, applies the same stage functions and
    pushes them on; the draft runs on an actor of its own, ahead of the
    target's in-flight verifies.  A kill stops a stale layer at whatever
    stage it sits.  On the card each actor launches on a CUDA stream of
    its own, ordered by events that ride the messages.

On one card the stages share the device, so the sharded backends give no
extra device; they run the paper's schedule.  Their arenas are dense
per-layer caches (the same buffers a ``KVArena`` keeps, grouped by stage
with no copy), or with ``paged=True`` every slot fully backed through a
static identity block table (``_full_table``), densified around the ring
as the reference does: the target's ring runs the dense kernels, the draft
the local path's kernels on its own (paged) arena.  The reference's
``donate=`` has no counterpart: the port's buffers are updated in place
already.  Every backend serves int8 bundles (``ModelBundle.quantize()``):
the stage functions run the int8 projections and attention modes, and the
cache helpers move each ``k_scale``/``v_scale`` leaf with its int8 rows.

``calls`` counts ``verify_rows`` (one draft verify per timestep with
pending entries), ``commit_rows`` and ``remap_rows``; the sharded
backends add ``pipeline_verify`` (one flush per timestep with entries) or
``pipeline_tick`` (one tick per executed timestep), ``ctrl_active_ticks``,
``drain_tick``, ``kill``, ``prefill_in_ring``/``prefill_chunks`` and the
ring's stage counts (``launch.pipeline``: ``stage_apply``,
``stage_layers``, ``stage_ctrl``, ``stage_prefill``, ``prefill_layers``).
The async backend counts ``stage_steps``, ``entry_msgs``, ``ctrl_msgs``,
``stale_exits``, ``kill``, ``pipeline_tick`` and ``drain`` as the
reference does, plus ``stage_layers`` and ``stage_ctrl``.
"""
from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.core.speculative import ModelBundle
from repro_torch.counting import bump
from repro_torch.launch import pipeline as pl
from repro_torch.models import paging
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed
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


def _full_table(slots: int, rows: int, page: int, device) -> torch.Tensor:
    """Fully backed identity block table: slot b's logical block j is
    physical block ``1 + b * mb + j`` (block 0 stays the null block).  The
    sharded backends page their arenas statically; allocation, swap and
    preemption live behind the local backend's ``PagedKVArena``."""
    mb = paging.n_blocks(rows, page)
    return torch.arange(1, 1 + slots * mb, dtype=torch.int32,
                        device=device).reshape(slots, mb)


def _paginate_full(cache: list, table: torch.Tensor, page: int) -> list:
    """Every leaf of a per-layer cache as a ``Paged`` leaf behind the
    shared ``table``."""
    return [{name: paging.make_paged(buf, table, page)
             for name, buf in layer.items()} for layer in cache]


class ShardedPipelineExecutor(PipelineExecutor):
    """SpecPipe-DB on the stage ring, flush schedule.

    The target's layers are cut into ``n_stages`` stages
    (``pipeline.stage_params``: the bundle's own layers, no copy) and its
    model and tree caches are per-layer slot-stacked buffers grouped by
    stage.  Each timestep with entries runs ONE flush
    (``calls["pipeline_verify"]``): the bucketed entry layer crosses every
    stage with its per-row metadata frozen at entry, and the exiting
    hidden states are unembedded into the verify logits.  The draft
    verifies and proposes through the local fused path.  Slot rows of the
    bucket that are not pending are empty rows (no committed prefix, an
    all-false mask): the ring computes them beside the pending rows, as
    the local verify does, and they write only their slack region
    (``pipeline.computed_rows``).  A bundle's prefix is baked in by
    ``prefill`` and its encoder output's cross K/V reach every stage.

    ``paged=True`` keeps every arena paged behind static identity tables
    (16-row ``page``s): the ring's target caches are densified around
    each flush (the bucketed views) and scattered back, and the draft
    reads its paged arena through the paged kernels as the local backend
    does."""

    def __init__(self, target: ModelBundle, draft: ModelBundle, *,
                 slots: int, max_len: int, tree_capacity: int,
                 capacity: int, n_stages: int, paged: bool = False,
                 page: int = 16):
        super().__init__(slots)
        width = tree_capacity - capacity
        if width < 1:
            raise ValueError("tree_capacity must include the width-w slack")
        self.target, self.draft = target, draft
        self.capacity, self.max_len = capacity, max_len
        self.n_stages = int(n_stages)
        self.paged, self.page = bool(paged), int(page)
        self.plcfg = pl.PipelineConfig(n_stages=self.n_stages, width=width,
                                       tree_capacity=capacity,
                                       max_len=max_len)
        self.stage_layers, self.stage_valid = pl.stage_params(
            target.model, self.n_stages)
        self.t_cache = target.init_cache(slots, max_len)
        self.t_tree = target.init_tree_caches(slots, tree_capacity)
        self.d_cache = draft.init_cache(slots, max_len)
        self.d_tree = draft.init_tree_caches(slots, tree_capacity)
        if self.paged:
            # one table per row geometry, shared by every leaf of it
            mt = _full_table(slots, max_len, self.page, target.device)
            tt = _full_table(slots, tree_capacity, self.page, target.device)
            self.t_cache = _paginate_full(self.t_cache, mt, self.page)
            self.t_tree = _paginate_full(self.t_tree, tt, self.page)
            self.d_cache = _paginate_full(self.d_cache, mt, self.page)
            self.d_tree = _paginate_full(self.d_tree, tt, self.page)
        self.arena = SlotPool(slots)
        self._verify = pl.make_pipeline_verify(
            target.cfg, self.plcfg, calls=self.calls,
            cross_kv=target.cross_kv,
            window_override=target.window_override)

    def _draft_cache(self):
        return self.d_cache

    def _draft_tree(self):
        return self.d_tree

    def _stages(self, cache: list) -> list:
        return pl.split_stages(cache, self.n_stages)

    def _entry(self, tokens, positions, masks, model_len, write_idx,
               valid, version=None) -> dict:
        """A ring entry over the given slot rows: the embedded layer and
        what the attention reads on the card, made once here."""
        dev = self.target.device
        model = self.target.model
        entry = {
            "act": embed(model.embed.table,
                         torch.as_tensor(tokens, device=dev).long()),
            "positions": torch.as_tensor(positions, device=dev).long(),
            "mask": torch.as_tensor(masks, device=dev, dtype=torch.bool),
            "model_len": torch.as_tensor(np.asarray(model_len),
                                         device=dev).to(torch.int32),
            "lens": np.asarray(model_len),
            "write_idx": np.asarray(write_idx), "valid": np.asarray(valid)}
        if version is not None:
            entry["version"] = np.asarray(version)
        return entry

    # -- interface ------------------------------------------------------
    def prefill(self, slot: int, prompt):
        t_logits, _ = self.target.prefill(
            prompt, tf.slice_cache_rows(self.t_cache, slot, 1))
        self.draft.prefill(prompt, tf.slice_cache_rows(self.d_cache, slot, 1))
        return t_logits

    def verify_rows(self, tokens, positions, masks, model_len, write_idx,
                    row_on):
        nb = self._rows_on(row_on)
        mkv = tf.slice_cache_rows(self.t_cache, 0, nb)
        tkv = tf.slice_cache_rows(self.t_tree, 0, nb)
        mkv_d, tkv_d = paging.densify(mkv), paging.densify(tkv)
        entry = self._entry(tokens[:nb], positions[:nb], masks[:nb],
                            model_len[:nb], write_idx[:nb],
                            np.asarray(row_on)[:nb])
        act, _ = self._verify(self.stage_layers, self.stage_valid,
                              self._stages(mkv_d), self._stages(tkv_d),
                              entry)
        if self.paged:
            paging.repaginate(tkv, tkv_d)
        v_all = tf._logits(self.target.model, act)
        d_all, _ = self._draft_verify(tokens, positions, masks, model_len,
                                      write_idx, row_on)
        self.calls["pipeline_verify"] += 1
        return v_all, d_all

    def commit_rows(self, model_len, commit_mask) -> None:
        node0 = np.zeros((self.slots,), np.int32)   # row 0 is the root
        self.target.commit_rows(self.t_cache, self.t_tree, node0, model_len,
                                commit_mask)
        self.draft.commit_rows(self.d_cache, self.d_tree, node0, model_len,
                               commit_mask)
        self.calls["commit_rows"] += 1

    def _draft_remap_row(self, slot: int, index_map) -> None:
        tf.remap_tree_cache_rows(tf.slice_cache_rows(self.d_tree, slot, 1),
                                 np.asarray(index_map, np.int32)[None])

    def remap_row(self, slot: int, index_map) -> None:
        tf.remap_tree_cache_rows(tf.slice_cache_rows(self.t_tree, slot, 1),
                                 np.asarray(index_map, np.int32)[None])
        self._draft_remap_row(slot, index_map)

    def remap_rows(self, index_maps, row_mask) -> None:
        """ONE batched gather per model over the slot-stacked tree caches
        (identity rows leave the other slots bit-unchanged)."""
        if not np.any(np.asarray(row_mask)):
            return
        for tree in (self.t_tree, self.d_tree):
            tf.remap_tree_cache_rows(tree, index_maps)
        self.calls["remap_rows"] += 1


class Deferred:
    """Future for what the ring gives at an exit tick: one slot's verify
    logits ([w, V]) of a tree layer, or (``version`` None) its admission
    prefill's last-position logits ([1, V]).

    Issued by ``OverlappedShardedExecutor`` when the layer or prompt
    enters the ring (``tick_rows``, ``begin_prefill``), stored by the
    engine (``Flight.logits``, ``_Joining.handle``) and resolved by the
    tick at which it exits.  A kill (miss, retire) marks every outstanding
    future of the slot dead, so a stale flight can never commit."""

    __slots__ = ("slot", "version", "_value", "dead")

    def __init__(self, slot: int, version: Optional[int] = None):
        self.slot, self.version = slot, version
        self._value, self.dead = None, False

    @property
    def ready(self) -> bool:
        return self._value is not None

    def resolve(self):
        what = (f"slot {self.slot} prefill" if self.version is None else
                f"slot {self.slot} tree version {self.version}")
        if self.dead:
            raise RuntimeError(f"stale flight: {what} was killed (pruned "
                               "or retired) while in flight")
        if self._value is None:
            raise RuntimeError(f"{what} consumed before its exit tick")
        return self._value


PREFILL_LANE = 64      # tokens of a prompt chunk in the ring's prefill lane
INBOX_DEPTH = 8        # messages a stage actor's inbox holds (async pipe)


class _CtrlQueue:
    """The target-side cache change queued for the next ctrl message of a
    ring: the exit commits (mask and committed length) and prune index
    maps the engine issued since the last message, merged per slot (a
    later commit's length and a later remap win).  ``active`` says whether
    anything was queued; ``drop(slot)`` cancels a retired slot's share and
    marks it for clearing (``clear``, read by the lockstep tick)."""

    def __init__(self, slots: int, capacity: int):
        self.identity = np.tile(np.arange(capacity, dtype=np.int64),
                                (slots, 1))
        self.reset()

    def reset(self) -> None:
        slots = self.identity.shape[0]
        self.commit = np.zeros((slots,), bool)
        self.len = np.zeros((slots,), np.int64)
        self.imap = self.identity.copy()
        self.clear = np.zeros((slots,), bool)
        self.active = False

    def commit_rows(self, model_len, commit_mask) -> None:
        mask = np.asarray(commit_mask, bool)
        self.commit |= mask
        self.len = np.where(mask, np.asarray(model_len).astype(np.int64),
                            self.len)
        if mask.any():
            self.active = True

    def remap_row(self, slot: int, index_map) -> None:
        self.imap[slot] = np.asarray(index_map, np.int64)
        self.active = True

    def remap_rows(self, index_maps, row_mask) -> None:
        self.imap = np.where(np.asarray(row_mask, bool)[:, None],
                             np.asarray(index_maps, np.int64), self.imap)
        self.active = True

    def drop(self, slot: int) -> None:
        self.commit[slot] = False
        self.len[slot] = 0
        self.imap[slot] = self.identity[slot]
        self.clear[slot] = True


class OverlappedShardedExecutor(ShardedPipelineExecutor):
    """The steady-state overlapped schedule on the stage ring: ONE tick per
    global timestep on a persistent ring.

    Differences from the flush parent, all at the seam:

      * ``tick_rows`` runs one tick over every slot row and returns
        ``Deferred`` futures: an entering layer's verify logits exist only
        at its exit tick (the engine never calls ``verify_rows`` here).
      * ``commit_rows`` / ``remap_row(s)`` queue the target-side cache
        change as the next tick's ctrl message, which trails the in-flight
        layers stage by stage (pruning propagation); the draft applies at
        once, as on the flush backend.  The message is marked active only
        when exit ctrl was queued, so the stages skip it otherwise
        (``calls["ctrl_active_ticks"]`` / ``calls["pipeline_tick"]`` is
        the active share).
      * ``begin_prefill(slot, prompt)`` streams the prompt through the
        ring's prefill lane in ``prefill_cap``-token chunks
        (``PREFILL_LANE``, at most ``max_len``) on consecutive ticks, the
        draft's chunk prefill beside each, so admission makes no separate
        prefill dispatch; it returns a ``Deferred`` resolved when the last
        chunk exits.  A bundle with a vision prefix, an encoder output or
        a window override turns the lane off (``prefill_cap`` 0,
        ``begin_prefill`` returns None), as the reference does: the lane
        embeds prompt tokens only, so admission goes through the parent's
        separate ``prefill``.
      * ``kill(slot)`` invalidates the slot's in-flight layers and bumps
        its tree version; ``drain()`` ticks dead entries until every
        outstanding future has resolved.

    Gating skips only identity messages and the lane's chunk attention
    computes the rows a one-shot pass would, so tokens equal the flush
    backend's.  The engine must tick every executed timestep, and its
    ``PipeDecConfig.n_stages`` must equal ``n_stages``: the ring is the
    flight bookkeeping."""

    overlapped = True

    def __init__(self, target: ModelBundle, draft: ModelBundle, *,
                 slots: int, max_len: int, tree_capacity: int,
                 capacity: int, n_stages: int, paged: bool = False,
                 page: int = 16):
        super().__init__(target, draft, slots=slots, max_len=max_len,
                         tree_capacity=tree_capacity, capacity=capacity,
                         n_stages=n_stages, paged=paged, page=page)
        self.prefill_cap = min(PREFILL_LANE, max_len)
        if any(b.prefix_embeds is not None or b.enc_out is not None
               or b.window_override >= 0 for b in (target, draft)):
            # the lane embeds prompt tokens only: a prefix, an encoder
            # output or a window override is baked in by the parent's
            # separate prefill, as the reference turns its lane off for
            # such bundles
            self.prefill_cap = 0
        self._ring = pl.init_ring(self.plcfg, slots)
        self._tick = pl.make_pipedec_tick(
            target.cfg, self.plcfg, calls=self.calls,
            cross_kv=target.cross_kv,
            window_override=target.window_override)
        # per-slot tree versions and outstanding futures
        self._versions = np.zeros((slots,), np.int64)
        self._handles = [collections.deque() for _ in range(slots)]
        self._p_handles: dict = {}
        # chunked prefill: queued (chunk, offset) pairs not yet entered,
        # and lane exits still due per slot (the future resolves at the
        # last one)
        self._p_queue: dict = {}
        self._p_exits: dict = {}
        self._ctrlq = _CtrlQueue(slots, capacity)
        self._kill_mask = np.zeros((slots,), bool)
        self._reset_prefill()
        w = self.plcfg.width
        self.dead_entry = (
            torch.zeros((slots, w), dtype=torch.long),           # tokens
            torch.zeros((slots, w), dtype=torch.long),           # positions
            torch.zeros((slots, w, tree_capacity), dtype=torch.bool),
            np.zeros((slots,), np.int64),                        # model_len
            np.full((slots,), capacity, np.int64))               # write_idx

    def _reset_prefill(self) -> None:
        self._p_tokens = np.zeros((self.slots, self.prefill_cap), np.int64)
        self._p_len = np.zeros((self.slots,), np.int64)
        self._p_on = np.zeros((self.slots,), bool)
        self._p_off = np.zeros((self.slots,), np.int64)

    def _stage_chunk(self, slot: int, chunk, off: int) -> None:
        """Load one prompt chunk into the slot's lane row for the next
        tick (tokens and the chunk's row offset)."""
        self._p_tokens[slot] = 0
        self._p_tokens[slot, :len(chunk)] = chunk
        self._p_len[slot] = len(chunk)
        self._p_off[slot] = off
        self._p_on[slot] = True

    # -- prefill in the ring --------------------------------------------
    def begin_prefill(self, slot: int, prompt):
        """Queue ``slot``'s admission prefill into the ring: the prompt is
        cut into ``prefill_cap``-token chunks entering the lane on
        consecutive ticks.  Returns a ``Deferred`` resolved at the last
        chunk's exit tick, or None when the ring has no lane
        (``prefill_cap`` 0): the caller prefills through ``prefill``."""
        if not self.prefill_cap:
            return None
        pr = np.asarray(prompt).reshape(-1).astype(np.int64)
        if self._handles[slot] or slot in self._p_handles:
            raise RuntimeError(
                f"slot {slot} still has outstanding futures at admission")
        cap = self.prefill_cap
        chunks = [(pr[i:i + cap], i)
                  for i in range(0, len(pr), cap)] or [(pr, 0)]
        self._versions[slot] += 1
        self._stage_chunk(slot, *chunks[0])
        if chunks[1:]:
            self._p_queue[slot] = collections.deque(chunks[1:])
        self._p_exits[slot] = len(chunks)
        h = Deferred(slot)
        self._p_handles[slot] = h
        self.calls["prefill_in_ring"] += 1
        self.calls["prefill_chunks"] += len(chunks)
        return h

    # -- the per-timestep tick ------------------------------------------
    def _dispatch_tick(self, tokens, positions, masks, model_len,
                       write_idx, row_on, counter: str) -> None:
        """One tick (taking the queued ctrl, kill and prefill chunks), then
        resolve the futures of every layer and prompt that exited."""
        cq = self._ctrlq
        ctrl_active = cq.active
        model = self.target.model
        dev = self.target.device
        mkv, tkv = paging.densify(self.t_cache), paging.densify(self.t_tree)
        dkv = None
        entry = None
        if row_on.any():
            entry = self._entry(tokens, positions, masks, model_len,
                                write_idx, row_on, self._versions)
        ctrl = {"commit": cq.commit, "commit_len": cq.len,
                "index_map": cq.imap, "clear": cq.clear,
                "active": ctrl_active}
        pentry = None
        if self._p_on.any():
            p_tok = torch.as_tensor(self._p_tokens, device=dev)
            pentry = {"act": embed(model.embed.table, p_tok),
                      "len": self._p_len, "on": self._p_on,
                      "off": self._p_off}
            # the draft prefills the entering chunks beside the ring
            dkv = paging.densify(self.d_cache)
            self.draft.prefill_chunk(self._p_tokens, dkv, self._p_off,
                                     on=self._p_on)
        self._ring, ex = self._tick(
            self.stage_layers, self.stage_valid, self._stages(mkv),
            self._stages(tkv), self._ring, entry,
            kill=self._kill_mask if self._kill_mask.any() else None,
            ctrl=ctrl, pentry=pentry)
        if self.paged:
            paging.repaginate(self.t_cache, mkv)
            paging.repaginate(self.t_tree, tkv)
            if dkv is not None:
                paging.repaginate(self.d_cache, dkv)
        if ctrl_active and counter == "pipeline_tick":
            # drain ticks are counted apart: the active share prices the
            # steady state only
            self.calls["ctrl_active_ticks"] += 1
        cq.reset()
        self._reset_prefill()
        self._kill_mask[:] = False
        # the lane is free again: each streaming prompt's next chunk
        # enters with the next tick
        for slot in list(self._p_queue):
            q = self._p_queue[slot]
            self._stage_chunk(slot, *q.popleft())
            if not q:
                del self._p_queue[slot]
        self.calls[counter] += 1

        exits = np.nonzero(ex["valid"])[0]
        logits = tf._logits(model, ex["act"]) if exits.size else None
        for slot in exits:
            q = self._handles[int(slot)]
            if not q:
                raise RuntimeError(
                    f"ring exit for slot {slot} with no outstanding flight")
            h = q.popleft()
            if h.version != int(ex["version"][slot]):
                raise RuntimeError(
                    f"tree-version mismatch at ring exit: slot {slot} "
                    f"entered at version {h.version}, exited carrying "
                    f"{int(ex['version'][slot])}")
            h._value = logits[slot]
        if ex["p_valid"].any():
            p_logits = tf._logits(model, ex["p_last"])
            for slot in np.nonzero(ex["p_valid"])[0]:
                s = int(slot)
                if s not in self._p_exits:
                    raise RuntimeError(f"prefill exit for slot {s} with no "
                                       "outstanding prefill future")
                self._p_exits[s] -= 1
                if self._p_exits[s] == 0:
                    # the last chunk's exit carries the prompt's last
                    # position; earlier exits only mark progress
                    del self._p_exits[s]
                    self._p_handles.pop(s)._value = p_logits[s:s + 1]

    def tick_rows(self, tokens, positions, masks, model_len, write_idx,
                  row_on):
        """ONE tick for this timestep over every slot row.  ``row_on``
        marks the rows entering a new tree layer.  Returns ``(d_all,
        handles)``: the draft's proposal logits over the bucketed entering
        rows (None when nothing enters) and each entering slot's
        ``Deferred``."""
        row_on = np.asarray(row_on, bool)
        handles = {}
        for slot in np.nonzero(row_on)[0]:
            h = Deferred(int(slot), int(self._versions[slot]))
            self._handles[int(slot)].append(h)
            handles[int(slot)] = h
        self._dispatch_tick(tokens, positions, masks, model_len, write_idx,
                            row_on, "pipeline_tick")
        d_all = None
        if row_on.any():
            d_all, _ = self._draft_verify(tokens, positions, masks,
                                          model_len, write_idx, row_on)
        return d_all, handles

    # -- the seam ---------------------------------------------------------
    def commit_rows(self, model_len, commit_mask) -> None:
        """Queue the target's exit commit as the next tick's ctrl message;
        the draft commits at once."""
        self._ctrlq.commit_rows(model_len, commit_mask)
        self.draft.commit_rows(self.d_cache, self.d_tree,
                               np.zeros((self.slots,), np.int32), model_len,
                               commit_mask)
        self.calls["commit_rows"] += 1

    def remap_row(self, slot: int, index_map) -> None:
        self._ctrlq.remap_row(slot, index_map)
        self._draft_remap_row(slot, index_map)

    def remap_rows(self, index_maps, row_mask) -> None:
        rm = np.asarray(row_mask, bool)
        if not rm.any():
            return
        imaps = np.asarray(index_maps, np.int64)
        self._ctrlq.remap_rows(imaps, rm)
        tf.remap_tree_cache_rows(self.d_tree, imaps)
        self.calls["remap_rows"] += 1

    # -- pruning propagation: miss and retire ---------------------------
    def kill(self, slot: int, *, drop_ctrl: bool = False) -> None:
        """Invalidate the slot's in-flight layers (miss, retire): the kill
        enters with the next tick, stale layers stop writing and exit
        invalid, and the slot's tree version moves on so that no stale
        future resolves.  A prefill still riding or queued for the slot
        dies with it.  ``drop_ctrl`` (retire) also cancels the slot's
        queued ctrl and clears its messages still riding; a miss keeps
        them: the missed request's earlier commits stay valid."""
        self._versions[slot] += 1
        self._kill_mask[slot] = True
        for h in self._handles[slot]:
            h.dead = True
        self._handles[slot].clear()
        ph = self._p_handles.pop(slot, None)
        if ph is not None:
            ph.dead = True
        self._p_on[slot] = False
        self._p_len[slot] = 0
        self._p_off[slot] = 0
        self._p_tokens[slot] = 0
        self._p_queue.pop(slot, None)
        self._p_exits.pop(slot, None)
        if drop_ctrl:
            self._ctrlq.drop(slot)
        self.calls["kill"] += 1

    def drain(self) -> int:
        """Tick dead entries until every outstanding future (verify and
        prefill) has resolved: at most ``n_stages - 1`` ticks plus one per
        chunk still queued.  Counted apart from the steady-state ticks."""
        row_on = np.zeros((self.slots,), bool)
        limit = self.n_stages + max(
            [len(q) for q in self._p_queue.values()], default=0)
        n = 0
        while any(self._handles) or self._p_handles:
            if n >= limit:
                raise RuntimeError("the ring failed to drain")
            self._dispatch_tick(*self.dead_entry, row_on, "drain_tick")
            n += 1
        return n


# ---------------------------------------------------------------------------
# free-running stage actors and a disaggregated draft actor
# ---------------------------------------------------------------------------
class AsyncExecutorError(RuntimeError):
    """An actor of ``AsyncPipelineExecutor`` raised (its traceback is in
    the message), or the host timed out waiting on the pipe.  Raised on
    the host thread by every blocking call of the executor, so a failed
    actor never hangs the engine."""


class _Abort(Exception):
    """Another actor failed: unwind this one quietly."""


def _on_stream(stream):
    """The calling thread's launches go to ``stream`` (None: the CPU, no
    stream).  The current stream is per thread, so each actor enters its
    own inside its loop."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _mark(stream):
    """A CUDA event recorded on ``stream`` behind every launch queued on
    it so far (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _adopt(event, tensors) -> None:
    """Make the calling thread's current stream wait for ``event`` (the
    producer's launches) before its next launch, and tell the caching
    allocator that ``tensors`` are in use on this stream too, so that the
    producer dropping them cannot free them early.  A no-op on the CPU."""
    if event is None:
        return
    cur = torch.cuda.current_stream()
    cur.wait_event(event)
    for t in tensors:
        if t is not None:
            t.record_stream(cur)


class _AsyncDeferred(Deferred):
    """A ``Deferred`` whose ``resolve`` pumps the exit queue: the async
    pipe delivers an exit whenever the last stage finishes, so the engine
    blocks here (bounded by ``timeout_s``, raising actor errors) until
    this flight's exit has been consumed."""

    __slots__ = ("_ex",)

    def __init__(self, slot: int, version: int, ex):
        super().__init__(slot, version)
        self._ex = ex

    def resolve(self):
        while self._value is None and not self.dead:
            self._ex._pump()
        return super().resolve()


class _DraftVerifyResult:
    """Future of one timestep's batched draft proposal logits ([bucket, w,
    V]), filled by the draft actor.  Indexing gives a slot's row as a
    ``resolve()``-able future, which ``PipeDecEngine.maybe_expand``
    resolves when it expands the tree."""

    __slots__ = ("_ex", "_event", "_value", "_cuda_event", "_adopted")

    def __init__(self, ex):
        self._ex = ex
        self._event = threading.Event()
        self._value = None
        self._cuda_event = None
        self._adopted = False

    def __getitem__(self, slot: int):
        return _DeferredDraftRow(self, int(slot))

    def wait(self):
        deadline = time.monotonic() + self._ex.timeout_s
        while not self._event.wait(0.05):
            self._ex._check_errors()
            if time.monotonic() > deadline:
                raise AsyncExecutorError(
                    f"timed out after {self._ex.timeout_s}s waiting for the "
                    "draft actor's verify")
        if not self._adopted:   # the host reads after the draft's launches
            _adopt(self._cuda_event, (self._value,))
            self._adopted = True
        return self._value


class _DeferredDraftRow:
    """One slot's row of a pending draft verify ([w, V] once resolved)."""

    __slots__ = ("_all", "slot")

    def __init__(self, all_, slot: int):
        self._all, self.slot = all_, slot

    def resolve(self):
        return self._all.wait()[self.slot]


class AsyncPipelineExecutor(PipelineExecutor):
    """Free-running stage actors and a disaggregated draft actor: the
    overlapped schedule without the host lockstep.

    Stage ``k`` is a daemon thread (``async-stage-k``) that takes messages
    from its bounded inbox (``INBOX_DEPTH``), applies the stage functions
    of ``launch.pipeline.make_stage_fns`` (the ones the lockstep tick
    runs) to its own slice of the per-layer caches (``split_stages``, no
    copy) and pushes the message to stage ``k + 1``; stage 0 embeds, and
    the last stage unembeds exits into an unbounded exit queue that the
    engine's thread consumes.  The draft lives on an actor of its own
    (``async-draft``) that owns the draft's caches and applies verify,
    commit, remap, remap_row and prefill jobs in the order the engine
    pushed them, so speculation runs ahead of the target's in-flight
    verifies (``draft_lead()``).

    Messages, one sequence through every stage in order:

      * ``layer`` - the entering tree layer over the bucket's slot rows
        (the local verify's power-of-two prefix): tokens and per-row
        metadata with a per-slot tree-version snapshot.  Each stage
        decides a row's liveness (snapshot == current version) when it
        *processes* the message, so a ``kill`` stops a stale layer at
        whatever stage it sits, not a ring revolution later; the bucket's
        empty rows are computed beside the live ones
        (``pipeline.computed_rows``), as the local verify computes them.
      * ``ctrl`` - pruning propagation: exit commit and prune index map
        with a ctrl-version snapshot, pushed before the next layer, so
        each stage sees the lockstep schedule's order.  A retire
        (``kill(drop_ctrl=True)``) bumps the slot's ctrl version and
        neutralises its messages still riding; a miss does not.
      * ``scatter`` - admission: the host prefills the target into a fresh
        cache (``prefill_cap`` is 0: no prefill lane) and its rows ride
        the pipe as one message, landing at each stage after the retired
        occupant's stale messages.
      * ``stop`` - shutdown.

    On the card each actor launches on a ``torch.cuda.Stream`` of its own.
    A message carries an event recorded on its producer's stream after its
    launches; the consumer's stream waits for it before its first launch,
    and every tensor that crosses streams is ``record_stream``-ed on the
    consumer's, so the caching allocator cannot hand it out early.  The
    host waits on an exit's (or the draft verify's) event before the
    engine reads its logits.  Cache buffers are written in place and each
    belongs to one actor.  On the CPU there are no streams or events and
    the code is otherwise the same.

    Greedy tokens equal the lockstep executors': each stage processes one
    global message sequence in order, as the lockstep schedule does, with
    the same stage functions on the same rows, and a stale layer that a
    kill stops earlier (or later) than the lockstep kill mask would only
    write rows a live tree rewrites before attending.

    Failures: an actor's exception is recorded, stops the other actors
    and re-raises on the host as ``AsyncExecutorError`` from every
    blocking call within ``timeout_s``.  ``shutdown()`` drains, stops and
    joins every actor (idempotent; a later use restarts them).  There is
    no paged arena: ``paged=True`` is refused.  ``pause()``/``resume()``
    hold the stage actors before their next message (a test hook)."""

    overlapped = True     # the engine drives the deferred-logits schedule
    prefill_cap = 0       # admission uses the separate-dispatch prefill

    def __init__(self, target: ModelBundle, draft: ModelBundle, *,
                 slots: int, max_len: int, tree_capacity: int,
                 capacity: int, n_stages: int, paged: bool = False,
                 timeout_s: float = 180.0):
        super().__init__(slots)
        if paged:
            raise ValueError("AsyncPipelineExecutor has no paged arena: "
                             "serve paged caches on the lockstep ring "
                             "(ShardedPipelineExecutor, paged=True)")
        width = tree_capacity - capacity
        if width < 1:
            raise ValueError("tree_capacity must include the width-w slack")
        self.target, self.draft = target, draft
        self.capacity, self.max_len = capacity, max_len
        self.n_stages = int(n_stages)
        self.timeout_s = float(timeout_s)
        self.paged = False
        self.plcfg = pl.PipelineConfig(n_stages=self.n_stages, width=width,
                                       tree_capacity=capacity,
                                       max_len=max_len)
        self.device = target.device
        self.arena = SlotPool(slots)
        self.stage_layers, self.stage_valid = pl.stage_params(
            target.model, self.n_stages)
        # the per-layer caches, grouped by stage: stage k's lists belong to
        # actor k, the draft's caches to the draft actor
        self.t_cache = target.init_cache(slots, max_len)
        self.t_tree = target.init_tree_caches(slots, tree_capacity)
        self._kv = pl.split_stages(self.t_cache, self.n_stages)
        self._tkv = pl.split_stages(self.t_tree, self.n_stages)
        self.d_cache = draft.init_cache(slots, max_len)
        self.d_tree = draft.init_tree_caches(slots, tree_capacity)
        self._apply, self._ctrl, _ = pl.make_stage_fns(
            target.cfg, self.plcfg, window_override=target.window_override)
        self._cross = pl.stage_cross(target.cross_kv, self.n_stages)
        self._views = [{} for _ in range(self.n_stages)]
        cuda = self.device.type == "cuda"
        # one stream per stage actor and one for the draft actor
        self._streams = [torch.cuda.Stream(device=self.device) if cuda
                         else None for _ in range(self.n_stages + 1)]

        # per-slot versions: layer staleness (bumped on every kill) and
        # ctrl staleness (bumped only when a retire drops its ctrl)
        self._versions = np.zeros((slots,), np.int64)
        self._ctrl_versions = np.zeros((slots,), np.int64)
        self._handles = [collections.deque() for _ in range(slots)]
        self._ctrlq = _CtrlQueue(slots, capacity)
        self.dead_entry = (
            np.zeros((slots, width), np.int64),                  # tokens
            np.zeros((slots, width), np.int64),                  # positions
            np.zeros((slots, width, tree_capacity), bool),       # masks
            np.zeros((slots,), np.int64),                        # model_len
            np.full((slots,), capacity, np.int64))               # write_idx

        # actor plumbing (the threads start on first use)
        self._inboxes = [queue.Queue(maxsize=INBOX_DEPTH)
                         for _ in range(self.n_stages)]
        self._exit_q: queue.Queue = queue.Queue()
        self._draft_q: queue.Queue = queue.Queue()
        self._errors: list = []
        self._failed = threading.Event()
        self._gate = threading.Event()       # pause()/resume()
        self._gate.set()
        self._threads: list = []
        self._started = False
        self._seq = 0
        self._pushed = self._consumed = 0
        self._draft_pushed = self._draft_done = 0
        self._draft_verified = 0
        self._exit_layers_consumed = 0
        self._max_draft_lead = 0
        self.stage_counters = [
            {"msgs": 0, "layers": 0, "stale_rows": 0, "ctrl_applied": 0,
             "ctrl_skipped": 0, "busy_s": 0.0, "idle_s": 0.0,
             "max_depth": 0}
            for _ in range(self.n_stages)]

    # -- small helpers ----------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        bump(self.calls, key, n)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _host_stream(self):
        return (torch.cuda.current_stream(self.device)
                if self.device.type == "cuda" else None)

    # -- host side: errors, feeding and consuming -------------------------
    def _check_errors(self) -> None:
        if self._errors:
            who, tb = self._errors[0]
            raise AsyncExecutorError(
                f"async pipeline actor '{who}' failed:\n{tb}")

    def _push(self, msg) -> None:
        """Feed stage 0's bounded inbox (bounded wait, raising actor
        errors)."""
        self._ensure_started()
        deadline = time.monotonic() + self.timeout_s
        while True:
            self._check_errors()
            try:
                self._inboxes[0].put(msg, timeout=0.1)
                break
            except queue.Full:
                if time.monotonic() > deadline:
                    raise AsyncExecutorError(
                        f"timed out after {self.timeout_s}s feeding the "
                        "stage-0 inbox (pipe stalled)")
        self._pushed += 1

    def _pump(self) -> None:
        """Consume one message from the exit queue (bounded wait, raising
        actor errors): the only consumer, on the engine's thread, so the
        futures' bookkeeping is single-threaded."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            self._check_errors()
            try:
                msg = self._exit_q.get(timeout=0.1)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise AsyncExecutorError(
                        f"timed out after {self.timeout_s}s waiting for a "
                        "pipeline exit")
                continue
            self._consume_exit(msg)
            return

    def _pump_ready(self) -> None:
        """Consume whatever exits have arrived (no wait)."""
        while True:
            try:
                msg = self._exit_q.get_nowait()
            except queue.Empty:
                return
            self._consume_exit(msg)

    def _consume_exit(self, msg) -> None:
        self._consumed += 1
        if msg[0] != "exit_layer":
            return                      # ctrl and scatter pass through
        _, _seq, logits, row_on, versions, event = msg
        self._exit_layers_consumed += 1
        _adopt(event, (logits,))
        for slot in np.nonzero(row_on)[0]:
            s = int(slot)
            if versions[s] != self._versions[s]:
                # killed after it entered: its future is dead already;
                # dropping the logits is the lockstep exit mask's job here
                self._count("stale_exits")
                continue
            q = self._handles[s]
            if not q:
                raise AsyncExecutorError(
                    f"ring exit for slot {s} with no outstanding flight")
            h = q.popleft()
            if h.version != int(versions[s]):
                raise AsyncExecutorError(
                    f"tree-version mismatch at ring exit: slot {s} entered "
                    f"at version {h.version}, exited carrying "
                    f"{int(versions[s])}")
            h._value = logits[s]

    # -- actor side: bounded, abort-aware queue operations ----------------
    def _aget(self, q):
        while True:
            if self._failed.is_set():
                raise _Abort
            try:
                return q.get(timeout=0.2)
            except queue.Empty:
                continue

    def _aput(self, q, msg) -> None:
        while True:
            if self._failed.is_set():
                raise _Abort
            try:
                q.put(msg, timeout=0.2)
                return
            except queue.Full:
                continue

    def _wait_gate(self) -> None:
        while not self._gate.wait(0.2):
            if self._failed.is_set():
                raise _Abort

    def pause(self) -> None:
        """Test hook: hold every stage actor before its next message."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    # -- the actors ---------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._started:
            return
        if self.device.type == "cuda":
            # the caches were zeroed on the host's stream
            torch.cuda.synchronize(self.device)
        self._started = True
        self._threads = []
        for k in range(self.n_stages):
            t = threading.Thread(target=self._stage_loop, args=(k,),
                                 name=f"async-stage-{k}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._draft_loop, name="async-draft",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _fail(self, who: str) -> None:
        self._errors.append((who, traceback.format_exc()))
        self._failed.set()

    def _stage_loop(self, k: int) -> None:
        ctr = self.stage_counters[k]
        inbox = self._inboxes[k]
        out = (self._inboxes[k + 1] if k + 1 < self.n_stages
               else self._exit_q)
        try:
            with torch.no_grad(), _on_stream(self._streams[k]):
                while True:
                    t_idle = time.perf_counter()
                    msg = self._aget(inbox)
                    ctr["idle_s"] += time.perf_counter() - t_idle
                    ctr["max_depth"] = max(ctr["max_depth"],
                                           inbox.qsize() + 1)
                    self._wait_gate()
                    t0 = time.perf_counter()
                    kind = msg[0]
                    if kind == "stop":
                        self._aput(out, msg)
                        return
                    if kind == "layer":
                        msg = self._stage_layer(k, ctr, msg)
                    elif kind == "ctrl":
                        self._stage_ctrl_msg(k, ctr, msg)
                    elif kind == "scatter":
                        self._stage_scatter(k, msg)
                    ctr["msgs"] += 1
                    ctr["busy_s"] += time.perf_counter() - t0
                    self._aput(out, msg)
        except _Abort:
            pass
        except BaseException:
            self._fail(f"stage{k}")

    def _bucket_caches(self, k: int, nb: int):
        """Stage ``k``'s target caches over slot rows [0, nb), as views
        made once per bucket size (the arena's tensors never change)."""
        if nb not in self._views[k]:
            self._views[k][nb] = (tf.slice_cache_rows(self._kv[k], 0, nb),
                                  tf.slice_cache_rows(self._tkv[k], 0, nb))
        return self._views[k][nb]

    def _stage_layer(self, k: int, ctr, msg):
        (_, seq, x, positions, mask, model_len, lens, empty, write_idx,
         row_on, versions, event) = msg
        nb = len(row_on)                # the bucket: slot rows [0, nb)
        # liveness when the stage processes the layer: a kill since entry
        # stops the stale rows here
        live = row_on & (versions[:nb] == self._versions[:nb])
        stale = int(np.count_nonzero(row_on & ~live))
        ctr["stale_rows"] += stale
        kv, tkv = self._bucket_caches(k, nb)
        if k == 0:                      # the host's arrays, embedded here
            dev = self.device
            x = embed(self.target.model.embed.table,
                      torch.as_tensor(x, device=dev).long())
            positions = torch.as_tensor(positions, device=dev).long()
            mask = torch.as_tensor(mask, device=dev, dtype=torch.bool)
            model_len = torch.as_tensor(model_len, device=dev).to(
                torch.int32)
            # the empty rows' indexes, built once a layer: every stage's
            # caches share one geometry, as on the lockstep ring
            empty = (pl.empty_rows(self.target.cfg, lens, mask, kv, tkv,
                                   write_idx) if live.any() else None)
        else:
            _adopt(event, (x, positions, mask, model_len,
                           *(vars(empty).values() if empty else ())))
        vrow = self.stage_valid[k]
        if live.any() and vrow.any():
            x = self._apply(self.stage_layers[k], vrow, kv, tkv, x,
                            positions, mask, write_idx, model_len,
                            pl.computed_rows(self.target.cfg, live, row_on,
                                             lens), empty=empty,
                            cross=self._cross[k])
            self._count("stage_layers", int(np.sum(vrow)))
        ctr["layers"] += 1
        self._count("stage_steps")
        stream = self._streams[k]
        if k == self.n_stages - 1:
            logits = (tf._logits(self.target.model, x) if live.any()
                      else None)
            return ("exit_layer", seq, logits, row_on, versions,
                    _mark(stream))
        return ("layer", seq, x, positions, mask, model_len, lens, empty,
                write_idx, row_on, versions, _mark(stream))

    def _stage_ctrl_msg(self, k: int, ctr, msg) -> None:
        _, _seq, commit_on, commit_len, imap, cvers = msg
        # ctrl liveness when processed: only a retire bumps the ctrl
        # version, so a recycled slot's trailing messages die mid-flight
        # while a missed slot's finish propagating
        live = cvers == self._ctrl_versions
        commit_on = commit_on & live
        identity = self._ctrlq.identity
        imap = np.where(live[:, None], imap, identity)
        if not commit_on.any() and np.array_equal(imap, identity):
            ctr["ctrl_skipped"] += 1    # neutralised: the identity
            return
        if self.stage_valid[k].any():
            self._ctrl(self._kv[k], self._tkv[k], commit_on,
                       np.where(live, commit_len, 0), imap)
            self._count("stage_ctrl")
        ctr["ctrl_applied"] += 1

    def _stage_scatter(self, k: int, msg) -> None:
        _, _seq, slot, src, event = msg
        rows = [c for c in src[k] if c is not None]
        _adopt(event, [buf for c in rows for buf in c.values()])
        for dst, s in zip(self._kv[k], src[k]):
            if dst is not None:
                for name, buf in dst.items():
                    buf[slot:slot + 1].copy_(s[name])

    def _draft_loop(self) -> None:
        try:
            with torch.no_grad(), _on_stream(self._streams[-1]):
                while True:
                    job = self._aget(self._draft_q)
                    kind = job[0]
                    if kind == "stop":
                        return
                    if kind == "verify":
                        self._draft_verify_job(job)
                    elif kind == "commit":
                        _, ml, mask = job
                        self.draft.commit_rows(
                            self.d_cache, self.d_tree,
                            np.zeros((self.slots,), np.int32), ml, mask)
                    elif kind == "remap":
                        tf.remap_tree_cache_rows(self.d_tree, job[1])
                    elif kind == "remap_row":
                        _, slot, imap = job
                        tf.remap_tree_cache_rows(
                            tf.slice_cache_rows(self.d_tree, slot, 1),
                            imap[None])
                    elif kind == "prefill":
                        _, slot, prompt = job
                        self.draft.prefill(
                            prompt, tf.slice_cache_rows(self.d_cache, slot,
                                                        1))
                    self._draft_done += 1
        except _Abort:
            pass
        except BaseException:
            self._fail("draft")

    def _draft_verify_job(self, job) -> None:
        _, tokens, positions, masks, model_len, write_idx, row_on, box = job
        nb = self._rows_on(row_on)
        d_all, _ = self.draft.tree_verify_rows(
            tokens[:nb], positions[:nb], masks[:nb], self.d_cache,
            model_len[:nb], self.d_tree, write_idx[:nb], bucket=nb)
        self._count("verify_rows")
        self._draft_verified += 1
        lead = self._draft_verified - self._exit_layers_consumed
        self._max_draft_lead = max(self._max_draft_lead, lead)
        box._value = d_all
        box._cuda_event = _mark(self._streams[-1])
        box._event.set()

    def _submit_draft(self, job) -> None:
        self._ensure_started()
        self._draft_q.put(job)
        self._draft_pushed += 1

    # -- the seam -----------------------------------------------------------
    def prefill(self, slot: int, prompt):
        """Admission (no prefill lane): the target prefills a fresh cache
        on the host's stream and its rows ride the pipe as ONE scatter
        message, after the retired occupant's stale messages and before
        the new occupant's first layer; the draft's prefill is a job of
        the draft actor, in the same push order.  Returns the target's
        last-position logits [1, V]."""
        self._ensure_started()
        self._check_errors()
        cache = self.target.init_cache(1, self.max_len)
        t_logits, _ = self.target.prefill(prompt, cache)
        self._push(("scatter", self._next_seq(), int(slot),
                    pl.split_stages(cache, self.n_stages),
                    _mark(self._host_stream())))
        self._submit_draft(("prefill", int(slot), np.array(prompt)))
        return t_logits

    def tick_rows(self, tokens, positions, masks, model_len, write_idx,
                  row_on):
        """One engine timestep: push the queued ctrl message (if any),
        then the entering layer and the draft's verify job.  Returns
        ``(d_all, handles)`` as the overlapped backend does: ``handles``
        are blocking ``Deferred`` futures and ``d_all`` a lazy draft
        verify (None when nothing enters).  A timestep with nothing to do
        pushes nothing: the pipe has no dead ticks."""
        self._ensure_started()
        self._check_errors()
        self._pump_ready()
        row_on = np.array(row_on, bool)
        cq = self._ctrlq
        if cq.active:
            # the message owns the arrays: reset() makes fresh ones
            self._push(("ctrl", self._next_seq(), cq.commit, cq.len,
                        cq.imap, self._ctrl_versions.copy()))
            self._count("ctrl_msgs")
            cq.reset()
        handles, d_all = {}, None
        if row_on.any():
            vers = self._versions.copy()
            for slot in np.nonzero(row_on)[0]:
                h = _AsyncDeferred(int(slot), int(vers[slot]), self)
                self._handles[int(slot)].append(h)
                handles[int(slot)] = h
            tok = np.array(tokens, np.int64)
            pos = np.array(positions, np.int64)
            msk = np.array(masks, bool)
            ml = np.array(model_len, np.int64)
            wi = np.array(write_idx, np.int64)
            # the target's layer spans the bucket, as the local verify;
            # model_len rides twice: made a tensor at stage 0, and on the
            # host (which rows are empty); stage 0 adds the empty rows
            nb = self._rows_on(row_on)
            self._push(("layer", self._next_seq(), tok[:nb], pos[:nb],
                        msk[:nb], ml[:nb], ml[:nb], None, wi[:nb],
                        row_on[:nb], vers, None))
            self._count("entry_msgs")
            d_all = _DraftVerifyResult(self)
            self._submit_draft(("verify", tok, pos, msk, ml, wi, row_on,
                                d_all))
        self._count("pipeline_tick")
        return d_all, handles

    def commit_rows(self, model_len, commit_mask) -> None:
        """Queue the target's exit commit into the next ctrl message (it
        trails the in-flight layers stage by stage); the draft's commit is
        a job in the same push order."""
        mask = np.array(commit_mask, bool)
        ml = np.array(model_len, np.int64)
        self._ctrlq.commit_rows(ml, mask)
        self._submit_draft(("commit", ml, mask))
        self._count("commit_rows")

    def remap_row(self, slot: int, index_map) -> None:
        imap = np.array(index_map, np.int64)
        self._ctrlq.remap_row(slot, imap)
        self._submit_draft(("remap_row", int(slot), imap))

    def remap_rows(self, index_maps, row_mask) -> None:
        rm = np.asarray(row_mask, bool)
        if not rm.any():
            return
        imaps = np.array(index_maps, np.int64)
        self._ctrlq.remap_rows(imaps, rm)
        self._submit_draft(("remap", imaps))
        self._count("remap_rows")

    def kill(self, slot: int, *, drop_ctrl: bool = False) -> None:
        """Invalidate the slot's in-flight layers wherever they sit: the
        version bump makes every stage's next liveness check stop the
        stale rows.  Outstanding futures die; ``drop_ctrl`` (retire) also
        cancels the slot's queued ctrl and, by the ctrl-version bump, its
        messages still riding (a miss keeps them: its earlier commits
        must finish propagating)."""
        self._versions[slot] += 1
        for h in self._handles[slot]:
            h.dead = True
        self._handles[slot].clear()
        if drop_ctrl:
            self._ctrlq.drop(slot)
            self._ctrl_versions[slot] += 1
        self._count("kill")

    def drain(self) -> int:
        """Block until every pushed message has left the last stage and
        the draft actor's queue is empty (bounded, raising actor errors):
        the pipe is idle and every future resolved.  Returns the exit
        messages consumed here."""
        if not self._started:
            return 0
        n = 0
        while self._consumed < self._pushed:
            self._pump()
            n += 1
        deadline = time.monotonic() + self.timeout_s
        while self._draft_done < self._draft_pushed:
            self._check_errors()
            if time.monotonic() > deadline:
                raise AsyncExecutorError(
                    f"timed out after {self.timeout_s}s draining the draft "
                    "actor")
            time.sleep(0.002)
        if any(self._handles):
            raise AsyncExecutorError(
                "drained pipe left unresolved flights: the exit and future "
                "bookkeeping is out of step")
        self._count("drain")
        return n

    def shutdown(self) -> None:
        """Drain the pipe, stop the actors and join their threads
        (idempotent; a later use starts them again).  After a failure the
        drain is skipped and the actors are released by the abort."""
        if not self._started:
            return
        self._gate.set()
        if not self._errors:
            try:
                self.drain()
            except AsyncExecutorError:
                pass
        stop = ("stop", self._next_seq())
        for q in (self._inboxes[0], self._draft_q):
            try:
                q.put(stop, timeout=1.0)
            except queue.Full:
                self._failed.set()
        deadline = time.monotonic() + min(self.timeout_s, 30.0)
        while not self._failed.is_set():
            try:
                msg = self._exit_q.get(timeout=0.1)
            except queue.Empty:
                if self._errors or time.monotonic() > deadline:
                    break
                continue
            if msg[0] == "stop":
                break
            self._consume_exit(msg)
        self._failed.set()               # release any blocked actor
        for t in self._threads:
            t.join(timeout=10.0)
        alive = [t.name for t in self._threads if t.is_alive()]
        for s in self._streams:
            if s is not None:
                s.synchronize()
        self._threads = []
        self._started = False
        self._failed = threading.Event()
        if alive:
            raise AsyncExecutorError(f"actor threads failed to join: "
                                     f"{alive}")

    # -- introspection --------------------------------------------------------
    def draft_lead(self) -> int:
        """Verify jobs the draft has completed ahead of the target exits
        the engine has consumed: how far speculation runs ahead."""
        return self._draft_verified - self._exit_layers_consumed

    def counters(self) -> dict:
        """The per-stage actor counters (messages, layer steps, stale rows
        stopped, ctrl applied and skipped, busy and idle seconds of the
        actor's thread, largest inbox depth) and the draft-lead gauges
        and message totals."""
        return {"stages": [dict(c) for c in self.stage_counters],
                "draft_lead": self.draft_lead(),
                "max_draft_lead": self._max_draft_lead,
                "pushed": self._pushed, "consumed": self._consumed}

    def _draft_cache(self):
        return self.d_cache

    def _draft_tree(self):
        return self.d_tree
