"""Block-paged KV storage for the serving arenas (the port of the JAX
package's ``repro/models/paging.py``).

A paged leaf replaces a dense slot-stacked cache leaf

    dense: [B, L, *row]            (slot axis, length axis, then the row:
                                    [KV, hd] for K/V, [KV] for int8 scales)

with a physical row pool plus a per-slot block table:

    pages: [n_blocks * page, *row]     flat physical rows
    table: [B, ceil(L / page)] int32   logical block -> physical block

Physical block 0 is the reserved *null block*: every unallocated logical
block of every slot aliases it, so gathers of regions not yet allocated
read rows that every attention mask already excludes, and masked or
out-of-range writes land there harmlessly.  The host-side free lists and
allocation policy live in ``serving.scheduler``; this module is the
device-side indirection.

Differences from the reference, by design of the port:

  * The port keeps a cache as a list of per-layer dicts, so a paged leaf
    never has the reference's leading ``reps`` axis: ``Paged`` has no
    ``n_pre`` (it is always 0).
  * Writes are in place on the shared pool (the JAX functions return new
    pools): a slot view (``slice_slots``) shares its pool with the arena,
    so what a bucketed dispatch writes through the view is in the arena
    already, and ``adopt_pool`` only checks that.
  * The kernels read a pool as a strided ``[Nb, KV, page, hd]`` view
    (``pool_view``), with no copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Paged:
    """One paged cache leaf: flat physical row pool + per-slot block table.

    ``pages``  [n_phys_rows, *row]: row r of physical block p is pool row
               ``p * page + r``; the row shape is the dense leaf's shape
               without its slot and length axes.
    ``table``  [B, n_logical_blocks] int32 on the pool's device; 0 (the
               null block) marks an unallocated logical block.
    ``page``   rows per block.
    ``length`` logical rows per slot (the dense leaf's length).
    """
    pages: torch.Tensor
    table: torch.Tensor
    page: int
    length: int

    @property
    def slots(self) -> int:
        """Slot rows the table covers."""
        return self.table.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        """The pool's element type."""
        return self.pages.dtype


def is_paged(x) -> bool:
    """Whether ``x`` is a paged leaf."""
    return isinstance(x, Paged)


def n_blocks(length: int, page: int) -> int:
    """Blocks that hold ``length`` rows."""
    return -(-length // page)


def pool_view(pages: torch.Tensor, page: int) -> torch.Tensor:
    """The kernels' blocked layout of a flat pool, as a view:
    [Nb*page, KV, hd] -> [Nb, KV, page, hd], and scale pools
    [Nb*page, KV] -> [Nb, KV, page]."""
    nb = pages.shape[0] // page
    return pages.view(nb, page, *pages.shape[1:]).transpose(1, 2)


def make_paged(dense: torch.Tensor, table, page: int) -> Paged:
    """A paged leaf holding ``dense`` [B, L, *row] behind ``table`` [B, mb]
    (ids from 1; the pool gets a null block 0 and one block per id up to
    the largest).  Rows of null-block entries land in the null block.
    A testing and migration helper."""
    table = torch.as_tensor(table, dtype=torch.int32, device=dense.device)
    b, mb = table.shape
    length = dense.shape[1]
    row = dense.shape[2:]
    pad = mb * page - length
    rows = dense
    if pad:
        rows = torch.cat([dense, dense.new_zeros((b, pad, *row))], dim=1)
    nb = int(table.max()) + 1 if table.numel() else 1
    pool = dense.new_zeros((nb * page, *row))
    idx = (table.long()[..., None] * page
           + torch.arange(page, device=dense.device)).reshape(-1)
    pool[idx] = rows.reshape(b * mb * page, *row)
    return Paged(pool, table, page, length)


def row_ids(p: Paged) -> torch.Tensor:
    """Physical pool row of every (slot, logical row): [B, L] int64."""
    ls = torch.arange(p.length, device=p.pages.device)
    return p.table.long()[:, ls // p.page] * p.page + ls % p.page


def to_dense(p: Paged) -> torch.Tensor:
    """Gather the dense [B, L, *row] view (unallocated logical rows read
    the null block)."""
    return p.pages[row_ids(p)]


def from_dense(p: Paged, dense: torch.Tensor) -> Paged:
    """Scatter a whole dense view back into the pool through the table, in
    place.  Rows of unallocated logical blocks all land in the null block
    (duplicate indices: whichever wins is never read meaningfully)."""
    p.pages[row_ids(p).reshape(-1)] = dense.reshape(
        -1, *dense.shape[2:]).to(p.pages.dtype)
    return p


def slice_slots(p: Paged, start: int, size: int) -> Paged:
    """Slot-row view: the table is sliced, the pool is shared."""
    return Paged(p.pages, p.table[start:start + size], p.page, p.length)


def adopt_pool(full: Paged, part: Paged) -> Paged:
    """Merge a slot view back into the full leaf.  The pool is shared and
    written in place, so the view's writes are in it already: this checks
    that and returns ``full``."""
    if part.pages.data_ptr() != full.pages.data_ptr():
        raise ValueError("adopt_pool: the slot view must share the pool")
    return full


def write_slot_rows(p: Paged, rows_dense: torch.Tensor, start: int) -> Paged:
    """Write dense rows of slots [start, start + size) (layout
    [size, L, *row]) into the pool through the table, in place: the paged
    ``update_cache_rows``."""
    view = slice_slots(p, start, rows_dense.shape[0])
    from_dense(view, rows_dense)
    return p


def _starts(starts, b: int, device) -> torch.Tensor:
    t = torch.as_tensor(starts, device=device).to(torch.int64).reshape(-1)
    return t.expand(b) if t.numel() == 1 else t


def len_rows(p: Paged, starts, n: int, on=None) -> torch.Tensor:
    """Physical rows [B, n] of logical rows [starts[b], starts[b] + n) of
    each slot; rows past the buffer end and rows of slots with ``on[b]``
    False are redirected to physical row 0 (the null block)."""
    dev = p.pages.device
    ls = _starts(starts, p.slots, dev)[:, None] + torch.arange(n, device=dev)
    inb = ls < p.length
    lb = ls.clamp(0, p.length - 1)
    phys = p.table.long().gather(1, lb // p.page) * p.page + lb % p.page
    keep = inb
    if on is not None:
        keep = keep & torch.as_tensor(on, device=dev).reshape(-1, 1)
    return torch.where(keep, phys, torch.zeros_like(phys))


def write_len_rows(p: Paged, u: torch.Tensor, starts, *, on=None,
                   rows: Optional[torch.Tensor] = None) -> Paged:
    """Per-slot contiguous write, in place: slot b's logical rows
    [starts[b], starts[b] + n) take ``u`` [B, n, *row].  Out-of-range rows
    and rows of slots with ``on[b]`` False go to the null block (drop
    semantics at the buffer edge).  ``rows`` passes the physical rows
    (``len_rows``) when several leaves of one table take the same write."""
    if rows is None:
        rows = len_rows(p, starts, u.shape[1], on)
    p.pages[rows.reshape(-1)] = u.reshape(-1, *u.shape[2:]).to(p.pages.dtype)
    return p


def take_len_rows(p: Paged, idx) -> torch.Tensor:
    """Per-slot gather of logical rows ``idx`` [B, n]: [B, n, *row]
    (indices past the end read the last logical row)."""
    dev = p.pages.device
    lb = torch.as_tensor(idx, device=dev).long().clamp(0, p.length - 1)
    phys = p.table.long().gather(1, lb // p.page) * p.page + lb % p.page
    return p.pages[phys]


def where_slots(on, new: Paged, old: Paged) -> Paged:
    """Per-slot select between two pools sharing one table: slot b's blocks
    take ``new`` where ``on[b]``, ``old`` elsewhere.  Ownership is
    resolved per block through the table (the null block's winner is
    arbitrary: its content is never read meaningfully).  Returns a new
    leaf on ``old``'s table."""
    dev = old.pages.device
    on = torch.as_tensor(on, device=dev).reshape(-1)
    nb_phys = new.pages.shape[0] // new.page
    owned = torch.zeros(nb_phys, dtype=torch.bool, device=dev)
    owned[new.table.long().reshape(-1)] = on.repeat_interleave(
        new.table.shape[1])
    sel = owned.repeat_interleave(new.page)
    sel = sel.reshape(-1, *([1] * (new.pages.dim() - 1)))
    return Paged(torch.where(sel, new.pages, old.pages), old.table,
                 old.page, old.length)


def _map(fn, cache):
    """``fn`` over the leaves of a cache: a leaf, a dict of leaves, or a
    list of per-layer dicts."""
    if isinstance(cache, list):
        return [_map(fn, c) for c in cache]
    if isinstance(cache, dict):
        return {k: _map(fn, v) for k, v in cache.items()}
    return fn(cache)


def _leaves(cache):
    if isinstance(cache, list):
        return [x for c in cache for x in _leaves(c)]
    if isinstance(cache, dict):
        return [x for v in cache.values() for x in _leaves(v)]
    return [cache]


def densify(cache):
    """A cache with every paged leaf replaced by its dense gather (a copy);
    dense leaves pass through."""
    return _map(lambda x: to_dense(x) if is_paged(x) else x, cache)


def repaginate(paged_cache, dense_cache):
    """Scatter a dense cache back through the paged cache's tables, in
    place; returns the paged cache (dense leaves take the dense values)."""
    if isinstance(paged_cache, list):
        return [repaginate(p, d) for p, d in zip(paged_cache, dense_cache)]
    if isinstance(paged_cache, dict):
        return {k: repaginate(paged_cache[k], dense_cache[k])
                for k in paged_cache}
    if is_paged(paged_cache):
        return from_dense(paged_cache, dense_cache)
    paged_cache.copy_(dense_cache)
    return paged_cache


def any_paged(cache) -> bool:
    """Whether any leaf of ``cache`` is paged."""
    return any(is_paged(x) for x in _leaves(cache))
