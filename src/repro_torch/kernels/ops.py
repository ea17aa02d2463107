"""Attention entry points of the port, composed from the two kernels.

``combine_lse`` merges partial attention results over disjoint KV sources
using their log-sum-exp stats: mathematically a joint softmax over the
concatenation (flash-decoding combination), which is how paper Algorithm
1's softmax(concat(S_past, S_predict)) is computed without materialising
the concatenation.  The tree entry points hand the committed-prefix half
to the tree kernel (``past=``), whose epilogue merges the halves on the
card with ``combine_lse``'s arithmetic; on the CPU the plain versions call
``combine_lse`` itself.

The device of the tensors picks the implementation: CUDA tensors launch
the kernels, CPU tensors take their plain versions (see ``flash``,
``tree_block`` and ``quant``).  There is no switch: a CUDA tensor always
takes the kernel, the int8 ones included.  The dense entry points also
take meta tensors, for the dry run's shape-only pass (``launch.dryrun``):
there the plain versions propagate shapes and compute nothing
(``_flash``, ``_tree``); the kernel wrappers themselves refuse meta.

int8 paths: per-row ``k_scale``/``v_scale`` side tensors mark K/V as
symmetric int8 (the int8 serving cache) and select the kernels' int8
mode; ``quant_matmul`` applies a quantized projection weight through the
``dequant_matmul`` kernel.

Paged paths (``paged_tree_attention``, ``paged_decode_attention``): K/V
live in block pools ``[Nb, KV, page, hd]`` read through per-row block
tables ``[B, mb]`` by the paged kernels (``paged``), with no dense copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash import (flash_attention_lse,
                                       flash_attention_lse_plain, qpos_rows,
                                       rows_i32)
from repro_torch.kernels.paged import (paged_flash_attention_lse,
                                       paged_tree_block_attention)
from repro_torch.kernels.quant import dequant_matmul
from repro_torch.kernels.tree_block import (combine_lse, tree_block_attention,
                                            tree_block_attention_plain)

__all__ = ["combine_lse", "tree_attention", "decode_attention",
           "prefill_attention", "chunk_attention", "full_attention",
           "paged_tree_attention",
           "paged_decode_attention", "dequant_matmul", "quant_matmul"]


def _flash(q, k, v, kv_len, qpos=None, *, scale: Optional[float] = None,
           **kw):
    """``flash_attention_lse``, or on meta tensors its plain version."""
    if q.device.type != "meta":
        return flash_attention_lse(q, k, v, kv_len, qpos, scale=scale, **kw)
    b, _, n, hd = q.shape
    return flash_attention_lse_plain(
        q, k, v, rows_i32(kv_len, b, q.device), qpos_rows(qpos, b, n,
                                                          q.device),
        scale=hd ** -0.5 if scale is None else scale, **kw)


def _tree(q, k, v, tree_mask, *, scale: Optional[float] = None, **kw):
    """``tree_block_attention``, or on meta tensors its plain version."""
    if q.device.type != "meta":
        return tree_block_attention(q, k, v, tree_mask, scale=scale, **kw)
    b, _, n, hd = q.shape
    mask = tree_mask if tree_mask.dim() == 3 else tree_mask[None]
    return tree_block_attention_plain(
        q, k, v, mask.to(torch.bool).expand(b, n, k.shape[2]),
        scale=hd ** -0.5 if scale is None else scale, **kw)


def tree_attention(q, k_past, v_past, k_tree, v_tree, tree_mask, past_len,
                   *, scale: Optional[float] = None, window: int = 0,
                   qpos=None, k_scale=None, v_scale=None, kt_scale=None,
                   vt_scale=None):
    """Two-level tree attention: the committed prefix (``past_len`` valid
    rows per batch row, optional sliding ``window`` against ``qpos``) and
    the tree buffer (ancestor mask ``[n,T]`` or ``[B,n,T]``), merged by
    ``combine_lse`` (on the card in the tree kernel's epilogue: two
    launches).  q [B,H,n,hd]; k/v_past [B,KV,L,hd]; k/v_tree [B,KV,T,hd];
    int8 caches pass ``k_scale``/``v_scale`` [B,KV,L] and
    ``kt_scale``/``vt_scale`` [B,KV,T].  Returns [B,H,n,hd]."""
    past = _flash(q, k_past, v_past, past_len, qpos, k_scale=k_scale,
                  v_scale=v_scale, scale=scale, window=window)
    return _tree(q, k_tree, v_tree, tree_mask, k_scale=kt_scale,
                 v_scale=vt_scale, scale=scale, past=past).to(q.dtype)


def decode_attention(q, k, v, kv_len, *, scale: Optional[float] = None,
                     window: int = 0, k_scale=None, v_scale=None):
    """Decode over a KV cache: q [B,H,n,hd] at position ``kv_len - 1`` of
    its batch row, k/v [B,KV,L,hd] with ``kv_len`` (int or [B]) valid
    rows, int8 with ``k_scale``/``v_scale`` [B,KV,L] when given.  Returns
    [B,H,n,hd]."""
    b, _, n, _ = q.shape
    kv = rows_i32(kv_len, b, q.device)
    qpos = (kv - 1)[:, None].expand(b, n)
    o, _, _ = _flash(q, k, v, kv, qpos, k_scale=k_scale, v_scale=v_scale,
                     scale=scale, window=window)
    return o.to(q.dtype)


def paged_tree_attention(q, k_pool, v_pool, table, kt_pool, vt_pool,
                         t_table, tree_mask, past_len, *,
                         scale: Optional[float] = None, window: int = 0,
                         qpos=None, k_scale=None, v_scale=None,
                         kt_scale=None, vt_scale=None):
    """Two-level tree attention over paged caches: the committed prefix in
    pools ``k/v_pool`` [Nb,KV,page,hd] through ``table`` [B,mb]
    (``past_len`` valid rows per batch row, optional ``window`` against
    ``qpos``) and the tree buffer in pools ``kt/vt_pool`` through
    ``t_table`` (ancestor mask ``[n,T]`` or ``[B,n,T]``), merged by
    ``combine_lse`` (on the card in the paged tree kernel's epilogue).
    int8 pools pass their scale pools [Nb,KV,page].  Returns [B,H,n,hd]."""
    past = paged_flash_attention_lse(q, k_pool, v_pool, table, past_len,
                                     qpos, k_scale=k_scale, v_scale=v_scale,
                                     scale=scale, window=window)
    return paged_tree_block_attention(q, kt_pool, vt_pool, t_table,
                                      tree_mask, k_scale=kt_scale,
                                      v_scale=vt_scale, scale=scale,
                                      past=past).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, table, kv_len, *,
                           scale: Optional[float] = None, window: int = 0,
                           k_scale=None, v_scale=None):
    """Decode over a paged KV cache: q [B,H,n,hd] at position ``kv_len -
    1`` of its batch row; pools [Nb,KV,page,hd] through ``table`` [B,mb]
    with ``kv_len`` (int or [B]) valid rows.  Returns [B,H,n,hd]."""
    b, _, n, _ = q.shape
    kv = rows_i32(kv_len, b, q.device)
    qpos = (kv - 1)[:, None].expand(b, n)
    o, _, _ = paged_flash_attention_lse(q, k_pool, v_pool, table, kv, qpos,
                                        k_scale=k_scale, v_scale=v_scale,
                                        scale=scale, window=window)
    return o.to(q.dtype)


def prefill_attention(q, k, v, positions, *, scale: Optional[float] = None,
                      window: int = 0, k_scale=None, v_scale=None):
    """Causal attention for prefill: q [B,H,S,hd], k/v [B,KV,S,hd] (int8
    with ``k_scale``/``v_scale`` [B,KV,S] when given), positions [S] or
    [B,S].  Returns [B,H,S,hd]."""
    o, _, _ = _flash(q, k, v, k.shape[2], positions, k_scale=k_scale,
                     v_scale=v_scale, scale=scale, window=window,
                     causal=True)
    return o.to(q.dtype)


def chunk_attention(q, k, v, kv_len, positions, *,
                    scale: Optional[float] = None, window: int = 0,
                    k_scale=None, v_scale=None):
    """Causal attention of a prompt chunk over a cache that already holds
    the chunk's rows (chunked prefill): q [B,H,n,hd] at ``positions``
    [B,n]; k/v [B,KV,L,hd] (int8 with ``k_scale``/``v_scale`` [B,KV,L])
    with ``kv_len`` [B] rows written; each query attends the keys at or
    before its position.  A query's chunks are those a one-shot causal
    prefill of the prompt gives it (``flash.chunk_plan``: the bound is
    its own position).  Returns [B,H,n,hd]."""
    o, _, _ = _flash(q, k, v, kv_len, positions, k_scale=k_scale,
                     v_scale=v_scale, scale=scale, window=window,
                     causal=True)
    return o.to(q.dtype)


def full_attention(q, k, v, *, scale: Optional[float] = None):
    """Unmasked attention of every query over all L keys: the encoder's
    bidirectional self-attention and the decoder's cross-attention.
    q [B,H,n,hd], k/v [B|1,KV,L,hd] (a size-1 batch of k/v serves every
    row of q, expanded without a copy).  Returns [B,H,n,hd]."""
    b = q.shape[0]
    if k.shape[0] != b:
        k, v = k.expand(b, *k.shape[1:]), v.expand(b, *v.shape[1:])
    o, _, _ = _flash(q, k, v, k.shape[2], None, scale=scale)
    return o.to(q.dtype)


def quant_matmul(x, q8, scale):
    """Apply a quantized weight (``q8`` int8 in the fp32 weight's layout,
    ``scale`` fp32 over its output-channel axes) to ``x``: x's trailing
    axes contract with the leading ``q8.ndim - scale.ndim`` axes of
    ``q8``.  The shapes collapse to one 2-D ``dequant_matmul`` and reshape
    back."""
    nin = q8.ndim - scale.ndim
    kdim = math.prod(q8.shape[:nin])
    batch = x.shape[:x.ndim - nin]
    y = dequant_matmul(x.reshape(-1, kdim).float(), q8.reshape(kdim, -1),
                       scale.reshape(-1))
    return y.reshape(*batch, *q8.shape[nin:])
