"""Paged attention kernels: the two attention kernels over a block-paged
KV arena, CUDA kernels + plain twins.

Replaces the JAX package's Pallas kernels ``repro/kernels/paged.py``
(``paged_flash_attention_lse`` and ``paged_tree_block_attention``).  The
cache is a pool of physical blocks read through a per-row block table
(``models.paging``)::

    k_pool / v_pool : [Nb, KV, page, hd]   (int8 with scale pools
                                            [Nb, KV, page])
    table           : [B, mb] int32        logical block -> physical block

Logical key ``t`` of batch row ``b`` is row ``t % page`` of physical
block ``table[b, t // page]``.  Masking stays logical, as in the
reference: a key is attended by its logical position only (``kv_len``,
``qpos``/causal/window for the flash half, the ancestor mask for the tree
half), so physical block 0, the null block every unallocated logical
block aliases, may be read but is never attended.  The port's pools are
flat ``[Nb * page, KV, hd]`` row pools; callers pass them as strided
``[Nb, KV, page, hd]`` views (``paging.pool_view``), with no copy.

The kernels are the paged modes of ``csrc/flash_attention_lse.cu`` and
``csrc/tree_block_attention.cu``: the dense kernels' plan, tiles, masks
and summation order, with only a key's address changed.  So a paged
kernel over a shuffled pool gives the same bits as the dense kernel over
the gathered view, and the paged tree kernel takes the same ``past=``
half to merge in its epilogue.  What bounds them on an H100 is what
bounds the dense kernels: at the main path's sizes a CTA's serial chain,
not the bytes; the table adds 4 bytes per ``page`` keys.

Dispatch: CPU tensors go to the plain versions, which gather the dense
view through the table and run the dense plain version; CUDA tensors go
to the kernel, or the wrapper raises.  ``launches`` and ``launches_int8``
on each wrapper count its kernel launches in the fp32 and the int8 mode;
``launches_hd256`` and ``launches_int8_hd256`` count those of them that
ran the head_dim 256 instance (Gemma).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.counting import bump_attr
from repro_torch.kernels import build
from repro_torch.kernels import flash, tree_block
from repro_torch.kernels.flash import (MAX_HEAD_DIM, check_kv,
                                       flash_attention_lse_plain,
                                       qpos_rows, rows_i32, scale_args)
from repro_torch.kernels.tree_block import tree_block_attention_plain

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# q + strides, k, v + pool strides, scales + strides, table, mb, page
_HEAD = [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I64,
         _P, _P, _I64, _I64, _I64, _P, _I32, _I32]
_FLASH_ARGTYPES = _HEAD + [_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                           _I32, _I32, _I32, _I32, _I32, _F32, _P]
# mask, the past half (o, m, l), the outputs (o, m, l), B, H, KV, n, T, hd,
# stage keys, scale, stream
_TREE_ARGTYPES = _HEAD + [_P, _P, _P, _P, _P, _P, _P] + [_I32] * 7 + [_F32,
                                                                      _P]


def gather_pool(pool, table, length: int):
    """The dense view of a pool through its block table: pool [Nb, KV,
    page, ...] and table [B, mb] give [B, KV, length, ...] (unallocated
    logical blocks read the null block)."""
    page = pool.shape[2]
    ls = torch.arange(length, device=pool.device)
    blk = table.long()[:, ls // page]                     # [B, L]
    rows = (ls % page).expand_as(blk)
    return pool[blk, :, rows].movedim(1, 2)               # [B, KV, L, ...]


def _gather_kv(k_pool, v_pool, table, length, k_scale, v_scale):
    k, v = gather_pool(k_pool, table, length), gather_pool(v_pool, table,
                                                           length)
    if k_scale is None:
        return k, v, None, None
    return (k, v, gather_pool(k_scale, table, length),
            gather_pool(v_scale, table, length))


def paged_flash_attention_lse_plain(q, k_pool, v_pool, table, kv_len,
                                    qpos=None, *, scale: float,
                                    window: int = 0, causal: bool = False,
                                    k_scale=None, v_scale=None):
    """Plain PyTorch version of the paged flash kernel: the dense view
    gathered through ``table`` (mb * page logical keys), then the dense
    plain version."""
    length = table.shape[1] * k_pool.shape[2]
    k, v, ks, vs = _gather_kv(k_pool, v_pool, table, length, k_scale,
                              v_scale)
    return flash_attention_lse_plain(q, k, v, kv_len, qpos, scale=scale,
                                     window=window, causal=causal,
                                     k_scale=ks, v_scale=vs)


def paged_tree_block_attention_plain(q, k_pool, v_pool, table, tree_mask, *,
                                     scale: float, k_scale=None,
                                     v_scale=None, past=None):
    """Plain PyTorch version of the paged tree kernel: the T = tree_mask
    width logical rows gathered through ``table``, then the dense plain
    version (merged with ``past`` when it is given)."""
    t = tree_mask.shape[-1]
    k, v, ks, vs = _gather_kv(k_pool, v_pool, table, t, k_scale, v_scale)
    return tree_block_attention_plain(q, k, v, tree_mask, scale=scale,
                                      k_scale=ks, v_scale=vs, past=past)


def _check(name, q, k_pool, v_pool, table, k_scale, v_scale, rows=None):
    """Shared argument checks (``rows``: the kernel's most rows per CTA,
    which bounds the GQA group, or None for no bound); returns (int8,
    table as contiguous int32)."""
    int8 = check_kv(name, k_pool, v_pool, k_scale, v_scale)
    b, h, _, hd = q.shape
    kvh = k_pool.shape[1]
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise TypeError(f"{name} kernel takes fp32 q with a contiguous head "
                        "dim")
    if (h % kvh or hd > MAX_HEAD_DIM or k_pool.shape[3] != hd
            or (rows is not None and h // kvh > rows)):
        raise ValueError(f"unsupported shape H={h} KV={kvh} hd={hd}")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{name}: table must be [B={b}, mb], got "
                         f"{tuple(table.shape)}")
    return int8, table.to(device=q.device, dtype=torch.int32).contiguous()


def _pool_args(k_pool, v_pool, k_scale, v_scale):
    return [k_pool.data_ptr(), v_pool.data_ptr(), *k_pool.stride()[:3],
            *scale_args(k_scale, v_scale)]


def _launch_flash(q, k_pool, v_pool, table, kv_len, qpos, *, scale, window,
                  causal, k_scale, v_scale):
    name = "paged_flash_attention_lse"
    int8, table = _check(name, q, k_pool, v_pool, table, k_scale, v_scale,
                         flash.ROWS)
    if (causal or window > 0) and qpos is None:
        raise ValueError("causal or window masking needs qpos")
    b, h, n, hd = q.shape
    kvh, page = k_pool.shape[1], k_pool.shape[2]
    o = torch.empty((b, h, n, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.launcher("flash_attention_lse", _FLASH_ARGTYPES,
                        symbol=f"{name}_launch")
    err = fn(q.data_ptr(), *q.stride()[:3],
             *_pool_args(k_pool, v_pool, k_scale, v_scale),
             table.data_ptr(), table.shape[1], page, kv_len.data_ptr(),
             None if qpos is None else qpos.data_ptr(),
             o.data_ptr(), m.data_ptr(), l.data_ptr(),
             *flash.scratch_for(q.device, b, kvh, n, h // kvh,
                                table.shape[1] * page, hd),
             b, h, kvh, n, hd, flash.queries_per_cta(h // kvh), int(causal),
             int(window), float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(name, err)
    mode = "launches_int8" if int8 else "launches"
    bump_attr(paged_flash_attention_lse, mode)
    if hd > 128:     # the head_dim 256 instance (Gemma)
        bump_attr(paged_flash_attention_lse, mode + "_hd256")
    return o, m, l


def paged_flash_attention_lse(q, k_pool, v_pool, table, kv_len, qpos=None, *,
                              k_scale=None, v_scale=None,
                              scale: Optional[float] = None, window: int = 0,
                              causal: bool = False):
    """q [B,H,n,hd]; k/v_pool [Nb,KV,page,hd] (views are read by stride);
    table [B,mb] int32; kv_len an int or per-row [B] valid prefix; qpos
    [n] or [B,n] absolute query positions (needed for ``causal`` and
    ``window``); k_scale/v_scale [Nb,KV,page] fp32 for int8 pools.

    Returns (o [B,H,n,hd], m [B,H,n], l [B,H,n]), all fp32.
    """
    b, h, n, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv = rows_i32(kv_len, b, q.device)
    qp = qpos_rows(qpos, b, n, q.device)
    if q.device.type == "cpu":
        return paged_flash_attention_lse_plain(
            q, k_pool, v_pool, table, kv, qp, scale=scale, window=window,
            causal=causal, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no paged_flash_attention_lse for {q.device}")
    return _launch_flash(q, k_pool, v_pool, table, kv, qp, scale=scale,
                         window=window, causal=causal, k_scale=k_scale,
                         v_scale=v_scale)


def _launch_tree(q, k_pool, v_pool, table, mask, *, scale, k_scale,
                 v_scale, past):
    name = "paged_tree_block_attention"
    int8, table = _check(name, q, k_pool, v_pool, table, k_scale, v_scale)
    b, h, n, hd = q.shape
    kvh, page = k_pool.shape[1], k_pool.shape[2]
    t = mask.shape[-1]
    if t > table.shape[1] * page:
        raise ValueError(f"{name}: T={t} rows exceed the table's "
                         f"{table.shape[1]} blocks of {page}")
    past_ptrs = [None] * 3 if past is None else tree_block.check_past(past, q)
    o, m, l = tree_block.outputs(q, past)
    fn = build.launcher("tree_block_attention", _TREE_ARGTYPES,
                        symbol=f"{name}_launch")
    err = fn(q.data_ptr(), *q.stride()[:3],
             *_pool_args(k_pool, v_pool, k_scale, v_scale),
             table.data_ptr(), table.shape[1], page, mask.data_ptr(),
             *past_ptrs, o.data_ptr(), None if m is None else m.data_ptr(),
             None if l is None else l.data_ptr(),
             b, h, kvh, n, t, hd, tree_block.stage_keys(t, hd),
             float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(name, err)
    mode = "launches_int8" if int8 else "launches"
    bump_attr(paged_tree_block_attention, mode)
    if hd > 128:     # the head_dim 256 instance (Gemma)
        bump_attr(paged_tree_block_attention, mode + "_hd256")
    return o if past is not None else (o, m, l)


def paged_tree_block_attention(q, k_pool, v_pool, table, tree_mask, *,
                               k_scale=None, v_scale=None,
                               scale: Optional[float] = None, past=None):
    """q [B,H,n,hd]; k/v_pool [Nb,KV,page,hd] tree pools indexed by
    ``table`` [B,mb]; tree_mask [n,T] or [B,n,T] bool over the logical
    tree rows (T <= mb * page); k_scale/v_scale [Nb,KV,page] fp32 for int8
    pools.

    Returns (o [B,H,n,hd], m [B,H,n], l [B,H,n]), all fp32; with ``past``
    = (o, m, l) of the committed-prefix half, the merged [B,H,n,hd] output
    (see ``tree_block.tree_block_attention``).
    """
    b, h, n, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    mask = tree_mask if tree_mask.dim() == 3 else tree_mask[None]
    mask = mask.to(device=q.device, dtype=torch.bool)
    mask = mask.expand(b, n, mask.shape[-1])
    if q.device.type == "cpu":
        return paged_tree_block_attention_plain(
            q, k_pool, v_pool, table, mask, scale=scale, k_scale=k_scale,
            v_scale=v_scale, past=past)
    if q.device.type != "cuda":
        raise RuntimeError(f"no paged_tree_block_attention for {q.device}")
    # a torch.bool buffer is one byte per entry, 0 or 1: the kernel's uint8
    return _launch_tree(q, k_pool, v_pool, table, mask.contiguous(),
                        scale=scale, k_scale=k_scale, v_scale=v_scale,
                        past=past)


paged_flash_attention_lse.launches = 0
paged_flash_attention_lse.launches_int8 = 0
paged_flash_attention_lse.launches_hd256 = 0
paged_flash_attention_lse.launches_int8_hd256 = 0
paged_tree_block_attention.launches = 0
paged_tree_block_attention.launches_int8 = 0
paged_tree_block_attention.launches_hd256 = 0
paged_tree_block_attention.launches_int8_hd256 = 0
