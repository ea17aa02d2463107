"""KV arena and admission scheduler for SpecPipe-DB: the port of the JAX
package's ``repro/serving/scheduler.py``.

The paper's dynamic batching keeps the pipeline full of *different*
requests: when one finishes, the next queued request joins at its prefill
and decodes beside the rest.  The pieces:

  * ``SlotPool`` - bare slot accounting (free list + in-use set).
  * ``KVArena`` - slot-stacked cache arenas (target and draft model
    caches and their two tree caches, each a list of per-layer dicts whose
    leaves carry a leading slot axis), so the fused per-timestep tree
    verify reads every in-flight request from one buffer.  Slots are
    recycled without zeroing: every mask is bounded by the new occupant's
    ``model_len`` or ancestor mask, so stale rows never leak, and a
    recurrent layer's state is overwritten by the new occupant's prefill.
  * ``PagePool`` / ``PageAllocator`` / ``PagedKVArena`` - the block-paged
    arena: every leaf is a pool of physical blocks behind a per-slot
    block table (``models.paging``).  Admission backs a request's horizon
    instead of ``max_len``; LRU swap-to-host and preemption of parked
    slots make room under page pressure.  The host keeps the tables in
    numpy and mirrors them to the card after every change (one copy per
    table into the tensor every paged leaf of that kind shares).
  * ``DynamicBatchScheduler`` - priority/deadline-aware admission of
    arrived requests onto free slots, with aging against starvation and
    requeue under page pressure.

Admission policy (priority + aging): each ``admit(now)`` admits, among the
*arrived* requests, the one with the highest effective priority

    eff(req, now) = req.priority
                    + (now - req.arrival_t) // aging        (anti-starvation)
                    + 1 if req.deadline_t is within ``aging`` timesteps

with ties broken by submission order, so default-priority traffic
submitted in arrival order is exact FIFO.  The free lists pop in the
reference's order, so the block tables equal the JAX package's over the
same sequence of operations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import paging
from repro_torch.models import transformer as tf


class SlotPool:
    """Free-list accounting for ``slots`` recyclable KV slots."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = slots
        self._free: List[int] = list(range(slots - 1, -1, -1))  # pop -> 0..
        self._in_use: set = set()

    @property
    def n_free(self) -> int:
        """Free slots."""
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Slots in use."""
        return len(self._in_use)

    def alloc(self) -> int:
        """Take the lowest free slot."""
        if not self._free:
            raise RuntimeError("KVArena exhausted: no free slot")
        slot = self._free.pop()
        if slot in self._in_use:
            raise RuntimeError(f"KV slot {slot} double-allocated")
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Return ``slot`` to the free list."""
        if slot not in self._in_use:
            raise RuntimeError(f"KV slot {slot} freed but not in use")
        self._in_use.remove(slot)
        self._free.append(slot)


def _device(buf) -> torch.device:
    """The device of a dense or paged leaf."""
    return (buf.pages if paging.is_paged(buf) else buf).device


def _cache_bytes(cache) -> int:
    total = 0
    for layer in cache:
        for buf in (layer or {}).values():
            arr = buf.pages if paging.is_paged(buf) else buf
            total += arr.numel() * arr.element_size()
    return total


class KVArena(SlotPool):
    """Slot-stacked KV cache arenas, allocated at the first admission and
    recycled across requests.

    ``stacked`` is (t_cache, d_cache, t_tree, d_tree), every leaf with a
    leading slot axis (a recurrent layer's state too; its tree cache is
    None): what the fused dispatch and the batched commit read and write
    in place.  ``caches(slot)`` gives a slot's batch-1 views for
    admission prefill; ``store`` writes rows back (a no-op for the views,
    which write in place)."""

    def __init__(self, target, draft, *, slots: int, max_len: int,
                 tree_capacity: int):
        super().__init__(slots)
        self.target, self.draft = target, draft
        self.max_len, self.tree_capacity = max_len, tree_capacity
        self._stacked: Optional[list] = None

    def _dense(self, slots: int, device=None) -> list:
        """Zeroed dense (t_cache, d_cache, t_tree, d_tree) for ``slots``
        slots (on the models' devices unless ``device`` is given)."""
        out = []
        for bundle, cap, make in (
                (self.target, self.max_len, tf.init_cache),
                (self.draft, self.max_len, tf.init_cache),
                (self.target, self.tree_capacity, tf.init_tree_caches),
                (self.draft, self.tree_capacity, tf.init_tree_caches)):
            out.append(make(bundle.cfg, slots, cap,
                            device=device or bundle.device))
        return out

    def bytes_per_slot(self) -> int:
        """KV bytes one slot pins across the four arenas, from shapes on
        the meta device (nothing is allocated)."""
        return sum(_cache_bytes(c) for c in self._dense(1, "meta"))

    def _ensure(self) -> None:
        if self._stacked is None:
            self._stacked = self._dense(self.slots)

    def alloc(self) -> int:
        slot = super().alloc()
        self._ensure()
        return slot

    def caches(self, slot: int) -> tuple:
        """Slot ``slot``'s (t_cache, d_cache, t_tree, d_tree) batch-1
        views into the arena."""
        if slot not in self._in_use:
            raise RuntimeError(f"slot {slot} not allocated")
        return tuple(tf.slice_cache_rows(c, slot, 1) for c in self._stacked)

    def store(self, slot: int, caches: tuple) -> None:
        """Write a request's (t_cache, d_cache, t_tree, d_tree) rows back
        into the arena (views of it are in it already); the next occupant
        reuses the slot, stale rows masked, not zeroed."""
        if slot not in self._in_use:
            raise RuntimeError(f"slot {slot} not allocated")
        for full, rows in zip(self._stacked, caches):
            tf.update_cache_rows(full, rows, slot)

    @property
    def stacked(self) -> tuple:
        """(t_cache, d_cache, t_tree, d_tree), slot axis leading."""
        self._ensure()
        return tuple(self._stacked)

    def pool_bytes(self) -> int:
        """Bytes the arena holds on the card."""
        self._ensure()
        return sum(_cache_bytes(c) for c in self._stacked)


class PagePool:
    """Free list of physical KV blocks of one kind (model or tree).

    Block ids run 1..n_blocks; physical block 0 is the reserved null
    block and is never handed out.  Tracks the peak in use."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need at least one block, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks, 0, -1))  # pop -> 1..
        self.in_use = 0
        self.peak = 0

    @property
    def n_free(self) -> int:
        """Free blocks."""
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing allocation of ``n`` block ids (None when the pool
        cannot give them: the caller requeues or swaps a victim out)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.in_use += n
        self.peak = max(self.peak, self.in_use)
        return ids

    def free(self, ids: List[int]) -> None:
        """Return block ids to the pool."""
        for i in ids:
            if i == 0:
                raise RuntimeError("the null block cannot be freed")
            self._free.append(i)
        self.in_use -= len(ids)


class PageAllocator:
    """Host-side block tables and free pools of a paged arena.

    One numpy ``[slots, blocks_per_slot]`` table per block kind: "model"
    rows (``max_len``) and "tree" rows (``tree_capacity``), shared by the
    target and the draft (their leaves differ in row width, not in row
    count).  Entry 0 means unallocated (the null block).  ``page`` is the
    block size in rows (a power of two); ``model_blocks``/``tree_blocks``
    cap the pools (the default backs every slot fully; fewer
    oversubscribe, and admission then fit-checks a request's horizon)."""

    def __init__(self, *, slots: int, page: int, max_len: int,
                 tree_capacity: int, model_blocks: Optional[int] = None,
                 tree_blocks: Optional[int] = None):
        if page < 1 or page & (page - 1):
            raise ValueError(f"page size must be a power of two, got {page}")
        self.page = page
        self.slots = slots
        self.nb_model_slot = paging.n_blocks(max_len, page)
        self.nb_tree_slot = paging.n_blocks(tree_capacity, page)
        self.model = PagePool(model_blocks or slots * self.nb_model_slot)
        self.tree = PagePool(tree_blocks or slots * self.nb_tree_slot)
        self.model_table = np.zeros((slots, self.nb_model_slot), np.int32)
        self.tree_table = np.zeros((slots, self.nb_tree_slot), np.int32)
        self._rows = {"model": np.zeros(slots, np.int64),
                      "tree": np.zeros(slots, np.int64)}
        self.swaps = 0
        self.preemptions = 0
        self.expand_copies = 0

    def _of(self, kind: str) -> Tuple[PagePool, np.ndarray]:
        return ((self.model, self.model_table) if kind == "model"
                else (self.tree, self.tree_table))

    def blocks_of(self, kind: str, slot: int) -> int:
        """Blocks of ``kind`` backing ``slot``."""
        _, table = self._of(kind)
        return int(np.count_nonzero(table[slot]))

    def ensure(self, kind: str, slot: int, rows: int) -> bool:
        """Back logical rows [0, rows) of ``slot``, growing by whole blocks
        (growth past the backed region is a copy-on-expand event).  False
        when the pool cannot."""
        pool, table = self._of(kind)
        need = paging.n_blocks(rows, self.page)
        have = self.blocks_of(kind, slot)
        if need > have:
            ids = pool.alloc(need - have)
            if ids is None:
                return False
            table[slot, have:need] = ids
            if have > 0:
                self.expand_copies += need - have
        self._rows[kind][slot] = max(self._rows[kind][slot], rows)
        return True

    def release(self, kind: str, slot: int) -> List[int]:
        """Free every block of ``kind`` backing ``slot``."""
        pool, table = self._of(kind)
        ids = [int(i) for i in table[slot] if i]
        pool.free(ids)
        table[slot] = 0
        self._rows[kind][slot] = 0
        return ids

    def release_slot(self, slot: int) -> None:
        """Free every block backing ``slot``."""
        self.release("model", slot)
        self.release("tree", slot)

    def counters(self) -> Dict[str, float]:
        """Page-pool counters: blocks in use, total and peak, internal
        fragmentation (allocated rows not used inside backed blocks),
        swaps, preemptions and copy-on-expand events."""
        in_use = self.model.in_use + self.tree.in_use
        used_rows = int(self._rows["model"].sum() + self._rows["tree"].sum())
        frag = (100.0 * (1.0 - used_rows / (in_use * self.page))
                if in_use else 0.0)
        return {"blocks_in_use": in_use,
                "blocks_total": self.model.n_blocks + self.tree.n_blocks,
                "peak_blocks": self.model.peak + self.tree.peak,
                "frag_pct": frag,
                "swaps": self.swaps,
                "preemptions": self.preemptions,
                "expand_copies": self.expand_copies}


class PagedKVArena(KVArena):
    """Block-paged KV arenas behind the ``KVArena`` interface.

    Every length-indexed leaf (K/V, and the int8 scales) is a
    ``paging.Paged`` pool behind the allocator's table of its kind; a
    recurrent layer's state stays dense ``[slots, ...]`` and has no tree
    arena (None); the leaves of a kind share
    one table tensor on the card, which ``_sync_tables`` overwrites after
    each allocation change.  The fused dispatches pass the paged leaves to
    the layers as they are (the paged kernels read the pools through the
    tables); admission prefill densifies the slot's view, prefills it and
    scatters it back through the table, as the reference does.

    On top of the base arena: admission fit-check of a request's horizon
    (prompt + budget + tree slack, capped at ``max_len``; plus the
    target's vision prefix, whose rows precede the prompt's: the
    reference leaves them out, so that a long prefix there writes its
    last rows into the null block); LRU
    swap-to-host (``swap_out``/``swap_in``: the slot's dense rows go to
    host memory and come back into possibly different blocks, invisibly
    behind the table); preemption of parked slots (``park``,
    ``swap_out_lru``)."""

    def __init__(self, target, draft, *, slots: int, max_len: int,
                 tree_capacity: int, page: int = 16,
                 model_blocks: Optional[int] = None,
                 tree_blocks: Optional[int] = None,
                 lazy_tree: bool = False):
        super().__init__(target, draft, slots=slots, max_len=max_len,
                         tree_capacity=tree_capacity)
        self.pages = PageAllocator(slots=slots, page=page, max_len=max_len,
                                   tree_capacity=tree_capacity,
                                   model_blocks=model_blocks,
                                   tree_blocks=tree_blocks)
        self.page = page
        self.prefix = target.prefix_len
        # lazy_tree backs only the busy tree region at bind and grows it by
        # ensure_tree() before expansion (copy-on-expand); the default
        # backs the whole tree capacity at admission
        self.lazy_tree = lazy_tree
        self._tables: Dict[str, torch.Tensor] = {}
        self._swapped: Dict[int, list] = {}
        self._swap_blocks: Dict[int, Tuple[int, int]] = {}
        self._parked: set = set()
        self._stamp: Dict[int, int] = {}
        self._clock = 0

    # -- arena construction --------------------------------------------
    def _paginate(self, bundle, kind: str, length: int) -> list:
        pool = self.pages.model if kind == "model" else self.pages.tree
        table = self._tables[kind]
        make = tf.init_cache if kind == "model" else tf.init_tree_caches
        proto = make(bundle.cfg, 1, 1, device="meta")
        out = []
        for layer_kind, layer in zip(tf.layer_kinds(bundle.cfg), proto):
            if layer_kind in tf.RECURRENT_KINDS:
                # dense slot rows (no length axis), no tree arena
                out.append(None if layer is None else
                           {name: torch.zeros((self.slots, *buf.shape[1:]),
                                              dtype=buf.dtype,
                                              device=bundle.device)
                            for name, buf in layer.items()})
                continue
            out.append({name: paging.Paged(
                torch.zeros(((pool.n_blocks + 1) * self.page,
                             *buf.shape[2:]), dtype=buf.dtype,
                            device=bundle.device),
                table, self.page, length) for name, buf in layer.items()})
        return out

    def _ensure(self) -> None:
        if self._stacked is not None:
            return
        dev = self.target.device
        # copies, on the CPU too, so the host tables reach the card only
        # through _sync_tables
        self._tables = {
            "model": torch.tensor(self.pages.model_table, device=dev),
            "tree": torch.tensor(self.pages.tree_table, device=dev)}
        self._stacked = [
            self._paginate(self.target, "model", self.max_len),
            self._paginate(self.draft, "model", self.max_len),
            self._paginate(self.target, "tree", self.tree_capacity),
            self._paginate(self.draft, "tree", self.tree_capacity)]

    def _sync_tables(self) -> None:
        """Mirror the host block tables to the card, in place, so every
        paged leaf (and every slot view of one) reads the new tables; the
        copies are ordered before any later kernel on the stream."""
        if self._stacked is None:
            return
        self._tables["model"].copy_(torch.from_numpy(self.pages.model_table))
        self._tables["tree"].copy_(torch.from_numpy(self.pages.tree_table))

    # -- per-slot views -------------------------------------------------
    def caches(self, slot: int) -> tuple:
        """Slot ``slot``'s rows as dense batch-1 copies (admission prefill
        and the looped reference path run on dense caches); ``store``
        scatters them back through the tables."""
        return tuple(paging.densify(c) for c in super().caches(slot))

    # -- admission policy ----------------------------------------------
    def _horizon(self, req) -> int:
        prompt = getattr(req, "prompt", None)
        plen = (self.prefix + len(prompt) if prompt is not None
                else self.max_len)
        budget = getattr(req, "max_new_tokens", None)
        if budget is None:
            budget = self.max_len
        # + tree_capacity: a final verify may commit a whole tree past the
        # budget before retire truncates the tokens
        return min(self.max_len, plen + budget + self.tree_capacity)

    def _tree_rows(self, req) -> int:
        return 1 if self.lazy_tree else self.tree_capacity

    def fits(self, req) -> bool:
        """Whether a free slot and the pages of ``req``'s horizon exist."""
        nm = paging.n_blocks(self._horizon(req), self.page)
        nt = paging.n_blocks(max(self._tree_rows(req), 1), self.page)
        return (self.n_free > 0 and self.pages.model.n_free >= nm
                and self.pages.tree.n_free >= nt)

    def bind(self, slot: int, req) -> None:
        """Back the admitted request's pages (right after ``alloc()``; a
        passing ``fits`` makes this infallible)."""
        ok = self.pages.ensure("model", slot, self._horizon(req))
        ok = ok and self.pages.ensure("tree", slot, self._tree_rows(req))
        if not ok:
            raise RuntimeError("bind() without a passing fits() check")
        self.touch(slot)
        self._sync_tables()

    def ensure_tree(self, slot: int, rows: int) -> None:
        """Copy-on-expand growth of the tree region (lazy_tree mode): back
        tree rows [0, rows) before an expansion writes them."""
        if not self.lazy_tree:
            return
        if not self.pages.ensure("tree", slot,
                                 min(rows, self.tree_capacity)):
            raise RuntimeError("tree page pool exhausted on expand")
        self._sync_tables()

    def free(self, slot: int) -> None:
        super().free(slot)
        self.pages.release_slot(slot)
        self._swapped.pop(slot, None)
        self._parked.discard(slot)
        self._stamp.pop(slot, None)
        self._sync_tables()

    # -- LRU swap-to-host / preemption ---------------------------------
    def touch(self, slot: int) -> None:
        """Mark ``slot`` as just used (LRU clock)."""
        self._clock += 1
        self._stamp[slot] = self._clock

    def park(self, slot: int) -> None:
        """Mark an in-use slot preemptible (its request is idle)."""
        if slot not in self._in_use:
            raise RuntimeError(f"slot {slot} not allocated")
        self._parked.add(slot)

    def swap_out(self, slot: int) -> None:
        """Copy a slot's dense rows (model and tree, target and draft) to
        host memory and free its blocks."""
        if slot not in self._in_use or slot in self._swapped:
            raise RuntimeError(f"slot {slot} cannot be swapped out")
        self._swapped[slot] = [
            [None if layer is None else {k: v.cpu() for k, v in
                                         layer.items()}
             for layer in paging.densify(tf.slice_cache_rows(c, slot, 1))]
            for c in self._stacked]
        self._swap_blocks[slot] = (self.pages.blocks_of("model", slot),
                                   self.pages.blocks_of("tree", slot))
        self.pages.release_slot(slot)
        self.pages.swaps += 1
        self._sync_tables()

    def swap_in(self, slot: int) -> bool:
        """Restore a swapped-out slot into newly allocated blocks (their
        ids may differ: the table hides that) and scatter its host rows
        back.  False when the pools cannot hold it yet."""
        if slot not in self._swapped:
            raise RuntimeError(f"slot {slot} is not swapped out")
        nm, nt = self._swap_blocks[slot]
        if self.pages.model.n_free < nm or self.pages.tree.n_free < nt:
            return False
        ok = self.pages.ensure("model", slot, nm * self.page)
        ok = ok and self.pages.ensure("tree", slot, nt * self.page)
        if not ok:
            raise RuntimeError("swap_in: pools changed under the check")
        self._sync_tables()
        rows = self._swapped.pop(slot)
        del self._swap_blocks[slot]
        for full, host in zip(self._stacked, rows):
            tf.update_cache_rows(
                full, [None if layer is None else
                       {k: v.to(_device(full[i][k])) for k, v in
                        layer.items()} for i, layer in enumerate(host)],
                slot)
        self.touch(slot)
        return True

    def swap_out_lru(self) -> Optional[int]:
        """Swap out the least recently touched parked slot (admission's
        make-room path); None when nothing is preemptible."""
        victims = [s for s in self._parked if s not in self._swapped]
        if not victims:
            return None
        slot = min(victims, key=lambda s: self._stamp.get(s, 0))
        self.swap_out(slot)
        self.pages.preemptions += 1
        return slot


@dataclasses.dataclass
class SchedulerStats:
    """Per-uid lifecycle timestamps (in global pipeline timesteps) and the
    occupancy trace."""
    submitted_t: Dict[int, int] = dataclasses.field(default_factory=dict)
    admitted_t: Dict[int, int] = dataclasses.field(default_factory=dict)
    finished_t: Dict[int, int] = dataclasses.field(default_factory=dict)
    occupancy: List[int] = dataclasses.field(default_factory=list)

    def queue_delay(self, uid: int) -> int:
        """Timesteps between arrival and admission."""
        return self.admitted_t[uid] - self.submitted_t[uid]


class DynamicBatchScheduler:
    """Priority/deadline-aware admission of arrived requests onto free KV
    slots.  ``aging`` is the anti-starvation bound: every ``aging``
    timesteps a queued request waits, its effective priority rises one
    level."""

    def __init__(self, arena: SlotPool, *, aging: int = 8):
        if aging < 1:
            raise ValueError(f"aging must be >= 1, got {aging}")
        self.arena = arena
        self.aging = aging
        # (submission seq, request): the seq is the FIFO tie-break, carried
        # with the request (so re-submitting one Request object is sound)
        self._entries: List[Tuple[int, object]] = []
        self._seq = 0
        self.stats = SchedulerStats()

    def submit(self, req) -> None:
        """Queue a request."""
        self._entries.append((self._seq, req))
        self._seq += 1
        self.stats.submitted_t[req.uid] = getattr(req, "arrival_t", 0)

    @property
    def queue(self) -> List:
        """Queued requests in submission order."""
        return [r for _, r in self._entries]

    @property
    def pending(self) -> int:
        """Queued requests."""
        return len(self._entries)

    def next_arrival(self) -> Optional[int]:
        """Earliest arrival among queued requests (None when empty)."""
        if not self._entries:
            return None
        return min(getattr(r, "arrival_t", 0) for _, r in self._entries)

    def effective_priority(self, req, now: int) -> int:
        """priority + waited // aging (+1 inside the deadline window)."""
        eff = getattr(req, "priority", 0)
        eff += max(0, now - getattr(req, "arrival_t", 0)) // self.aging
        deadline = getattr(req, "deadline_t", None)
        if deadline is not None and deadline - now <= self.aging:
            eff += 1
        return eff

    def _pop_best_entry(self, now: int):
        arrived = [(seq, r) for seq, r in self._entries
                   if getattr(r, "arrival_t", 0) <= now]
        if not arrived:
            return None
        entry = max(arrived,
                    key=lambda e: (self.effective_priority(e[1], now),
                                   -e[0]))
        self._entries.remove(entry)
        return entry

    def admit(self, now: int) -> List[Tuple[object, int]]:
        """Admit arrived requests, best effective priority first, while
        slots are free; returns [(request, slot)].  A paged arena adds a
        fit-check: a request whose pages do not fit first swaps out LRU
        parked slots, and failing that is requeued with its submission
        seq, so aging keeps raising its priority while it waits."""
        admitted: List[Tuple[object, int]] = []
        fits = getattr(self.arena, "fits", None)
        swap_lru = getattr(self.arena, "swap_out_lru", None)
        bind = getattr(self.arena, "bind", None)
        while self.arena.n_free:
            entry = self._pop_best_entry(now)
            if entry is None:
                break
            _, req = entry
            if fits is not None and not fits(req):
                while (swap_lru is not None and not fits(req)
                       and swap_lru() is not None):
                    pass
                if not fits(req):
                    self._entries.append(entry)   # requeue, seq preserved
                    break
            slot = self.arena.alloc()
            if bind is not None:
                bind(slot, req)
            self.stats.admitted_t[req.uid] = now
            admitted.append((req, slot))
        return admitted

    def retire(self, uid: int, slot: int, now: int, caches=None) -> None:
        """Release a finished request's slot (writing its caches back
        first when given) for the next refill."""
        if caches is not None:
            self.arena.store(slot, caches)
        self.arena.free(slot)
        self.stats.finished_t[uid] = now
