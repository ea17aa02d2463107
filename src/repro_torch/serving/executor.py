"""Compute backends for SpecPipe-DB, the executor seam: the port of the
JAX package's ``repro/serving/executor.py`` (``PipelineExecutor``,
``LocalFusedExecutor``, ``ShardedPipelineExecutor`` and
``OverlappedShardedExecutor``).

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

On one card the stages share the device, so the sharded backends give no
extra device; they run the paper's schedule.  Their arenas are dense
per-layer caches (the same buffers a ``KVArena`` keeps, grouped by stage
with no copy), or with ``paged=True`` every slot fully backed through a
static identity block table (``_full_table``), densified around the ring
as the reference does: the target's ring runs the dense kernels, the draft
the local path's kernels on its own (paged) arena.  The reference's
``donate=`` has no counterpart: the port's buffers are updated in place
already.  The int8 bundles (``--quant int8``) and the reference's
``AsyncPipelineExecutor`` are not ported to the ring (``ROADMAP.md``
queue 1 item 11b).

``calls`` counts ``verify_rows`` (one draft verify per timestep with
pending entries), ``commit_rows`` and ``remap_rows``; the sharded
backends add ``pipeline_verify`` (one flush per timestep with entries) or
``pipeline_tick`` (one tick per executed timestep), ``ctrl_active_ticks``,
``drain_tick``, ``kill``, ``prefill_in_ring``/``prefill_chunks`` and the
ring's stage counts (``launch.pipeline``: ``stage_apply``,
``stage_layers``, ``stage_ctrl``, ``stage_prefill``, ``prefill_layers``).
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.core.speculative import ModelBundle
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
    bucket that are not pending ride along invalid: they leave the tree
    caches untouched.

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
        if target.cfg.quant or draft.cfg.quant:
            raise NotImplementedError(
                "int8 bundles are not served on the pipeline ring: "
                "ROADMAP.md queue 1 item 11b")
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
        self._verify = pl.make_pipeline_verify(target.cfg, self.plcfg,
                                               calls=self.calls)

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
        chunk exits.
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
        self._ring = pl.init_ring(self.plcfg, slots)
        self._tick = pl.make_pipedec_tick(target.cfg, self.plcfg,
                                          calls=self.calls)
        # per-slot tree versions and outstanding futures
        self._versions = np.zeros((slots,), np.int64)
        self._handles = [collections.deque() for _ in range(slots)]
        self._p_handles: dict = {}
        # chunked prefill: queued (chunk, offset) pairs not yet entered,
        # and lane exits still due per slot (the future resolves at the
        # last one)
        self._p_queue: dict = {}
        self._p_exits: dict = {}
        self._identity_imap = np.tile(np.arange(capacity, dtype=np.int64),
                                      (slots, 1))
        self._kill_mask = np.zeros((slots,), bool)
        self._reset_ctrl()
        self._reset_prefill()
        w = self.plcfg.width
        self.dead_entry = (
            torch.zeros((slots, w), dtype=torch.long),           # tokens
            torch.zeros((slots, w), dtype=torch.long),           # positions
            torch.zeros((slots, w, tree_capacity), dtype=torch.bool),
            np.zeros((slots,), np.int64),                        # model_len
            np.full((slots,), capacity, np.int64))               # write_idx

    def _reset_ctrl(self) -> None:
        self._ctrl_commit = np.zeros((self.slots,), bool)
        self._ctrl_len = np.zeros((self.slots,), np.int64)
        self._ctrl_imap = self._identity_imap.copy()
        self._ctrl_clear = np.zeros((self.slots,), bool)
        self._ctrl_active = False

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
        chunk's exit tick."""
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
        ctrl_active = self._ctrl_active
        model = self.target.model
        dev = self.target.device
        mkv, tkv = paging.densify(self.t_cache), paging.densify(self.t_tree)
        dkv = None
        entry = None
        if row_on.any():
            entry = self._entry(tokens, positions, masks, model_len,
                                write_idx, row_on, self._versions)
        ctrl = {"commit": self._ctrl_commit, "commit_len": self._ctrl_len,
                "index_map": self._ctrl_imap, "clear": self._ctrl_clear,
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
        self._reset_ctrl()
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
        mask = np.asarray(commit_mask, bool)
        ml = np.asarray(model_len).astype(np.int64)
        self._ctrl_commit |= mask
        self._ctrl_len = np.where(mask, ml, self._ctrl_len)
        if mask.any():
            self._ctrl_active = True
        self.draft.commit_rows(self.d_cache, self.d_tree,
                               np.zeros((self.slots,), np.int32), model_len,
                               commit_mask)
        self.calls["commit_rows"] += 1

    def remap_row(self, slot: int, index_map) -> None:
        self._ctrl_imap[slot] = np.asarray(index_map, np.int64)
        self._ctrl_active = True
        self._draft_remap_row(slot, index_map)

    def remap_rows(self, index_maps, row_mask) -> None:
        rm = np.asarray(row_mask, bool)
        if not rm.any():
            return
        imaps = np.asarray(index_maps, np.int64)
        self._ctrl_imap = np.where(rm[:, None], imaps, self._ctrl_imap)
        self._ctrl_active = True
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
            self._ctrl_commit[slot] = False
            self._ctrl_len[slot] = 0
            self._ctrl_imap[slot] = self._identity_imap[slot]
            self._ctrl_clear[slot] = True
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
