"""Plain PyTorch oracles of the attention paths, as the JAX package's
``repro/kernels/ref.py`` writes them: masked scores are -inf and the
softmax is taken over the concatenated sources.  They hold the kernels'
plain versions to the reference semantics, the paged oracles included
(gather the dense view through the block table, then the dense oracle).
"""
from __future__ import annotations

import math

import torch


def _repeat_kv(x, rep: int):
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=1)


def tree_attention_ref(q, k_past, v_past, k_tree, v_tree, tree_mask,
                       past_len, *, scale=None):
    """Two-level tree attention (paper Algorithm 1), dense reference.

    q [B,H,n,hd]; k/v_past [B,KV,Lmax,hd] (valid rows < past_len, an int or
    per-row [B]); k/v_tree [B,KV,T,hd]; tree_mask [n,T] or [B,n,T] bool.
    Returns [B,H,n,hd].
    """
    b, h, n, hd = q.shape
    rep = h // k_past.shape[1]
    k_past, v_past = _repeat_kv(k_past, rep), _repeat_kv(v_past, rep)
    k_tree, v_tree = _repeat_kv(k_tree, rep), _repeat_kv(v_tree, rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lp = torch.einsum("bhnd,bhsd->bhns", q, k_past).float() * scale
    lt = torch.einsum("bhnd,bhsd->bhns", q, k_tree).float() * scale
    lmax = k_past.shape[2]
    plen = torch.as_tensor(past_len, device=q.device).reshape(-1).expand(b)
    past_ok = torch.arange(lmax, device=q.device)[None, None, None, :] < \
        plen[:, None, None, None]
    tmask = tree_mask if tree_mask.dim() == 3 else tree_mask[None]
    lp = lp.masked_fill(~past_ok, -math.inf)
    lt = lt.masked_fill(~tmask[:, None], -math.inf)
    probs = torch.softmax(torch.cat([lp, lt], dim=-1), dim=-1)
    return torch.einsum("bhns,bhsd->bhnd", probs[..., :lmax], v_past) + \
        torch.einsum("bhns,bhsd->bhnd", probs[..., lmax:], v_tree)


def _dequant(q8, row_scale):
    """int8 values [..., L, hd] times per-row fp32 scales [..., L] -> fp32."""
    return q8.float() * row_scale[..., None]


def tree_attention_quant_ref(q, k_past, v_past, k_tree, v_tree, tree_mask,
                             past_len, *, k_scale, v_scale, kt_scale,
                             vt_scale, scale=None):
    """Quantized two-level tree attention: int8 K/V with per-row fp32
    scales (``k_scale``/``v_scale`` [B,KV,Lmax], ``kt_scale``/``vt_scale``
    [B,KV,T]) dequantized densely, then the fp32 reference."""
    return tree_attention_ref(
        q, _dequant(k_past, k_scale), _dequant(v_past, v_scale),
        _dequant(k_tree, kt_scale), _dequant(v_tree, vt_scale),
        tree_mask, past_len, scale=scale)


def dequant_matmul_ref(x, w_q, w_scale):
    """x [M,K] f32 @ int8 w_q [K,N] with per-out-channel fp32 scales [N] ->
    [M,N] f32, the scale applied after the fp32 sum."""
    return (x.float() @ w_q.float()) * w_scale


def decode_attention_ref(q, k, v, kv_len, *, window: int = 0, scale=None):
    """Flash-decode reference: q [B,H,1,hd] vs cache k/v [B,KV,Lmax,hd]
    with ``kv_len`` (int or [B]) valid rows and an optional sliding
    window.  Returns [B,H,1,hd]."""
    b, h, _, hd = q.shape
    rep = h // k.shape[1]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bhnd,bhsd->bhns", q, k).float() * scale
    pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1)
    ok = pos < kv_len
    if window:
        ok &= pos > kv_len - 1 - window
    probs = torch.softmax(logits.masked_fill(~ok, -math.inf), dim=-1)
    return torch.einsum("bhns,bhsd->bhnd", probs, v)


def decode_attention_quant_ref(q, k, v, kv_len, *, k_scale, v_scale,
                               window: int = 0, scale=None):
    """Quantized flash-decode reference: int8 k/v [B,KV,Lmax,hd] with
    per-row fp32 scales [B,KV,Lmax], dequantized then scored in fp32."""
    return decode_attention_ref(q, _dequant(k, k_scale), _dequant(v, v_scale),
                                kv_len, window=window, scale=scale)


def paged_gather_ref(pool, table, length: int):
    """Dense view of a paged pool: pool [Nb, KV, page, hd] (or scales
    [Nb, KV, page]) gathered through ``table`` [B, mb] into
    [B, KV, length, ...]; unallocated logical blocks read physical block 0,
    the null block, whose rows every mask excludes."""
    page = pool.shape[2]
    ls = torch.arange(length, device=pool.device)
    blk = torch.as_tensor(table, device=pool.device).long()[:, ls // page]
    g = pool[blk]                                     # [B, L, KV, page, ...]
    r = (ls % page).reshape(1, length, 1, 1, *([1] * (g.dim() - 4)))
    r = r.expand(*g.shape[:3], 1, *g.shape[4:])
    g = torch.take_along_dim(g, r, dim=3).squeeze(3)  # [B, L, KV, ...]
    return g.movedim(1, 2)                            # [B, KV, L, ...]


def paged_decode_attention_ref(q, k_pool, v_pool, table, kv_len, *,
                               k_scale=None, v_scale=None, window: int = 0,
                               scale=None):
    """Paged flash-decode reference: the dense view gathered through the
    block table, then the dense reference (dequantized when scales are
    given)."""
    length = table.shape[1] * k_pool.shape[2]
    k = paged_gather_ref(k_pool, table, length)
    v = paged_gather_ref(v_pool, table, length)
    if k_scale is not None:
        k = _dequant(k, paged_gather_ref(k_scale, table, length))
        v = _dequant(v, paged_gather_ref(v_scale, table, length))
    return decode_attention_ref(q, k, v, kv_len, window=window, scale=scale)


def paged_tree_attention_ref(q, k_pool, v_pool, table, kt_pool, vt_pool,
                             t_table, tree_mask, past_len, *, k_scale=None,
                             v_scale=None, kt_scale=None, vt_scale=None,
                             scale=None):
    """Paged two-level tree attention reference: both halves gathered dense
    through their tables, then the joint-softmax reference."""
    lp = table.shape[1] * k_pool.shape[2]
    tcap = tree_mask.shape[-1]
    kp = paged_gather_ref(k_pool, table, lp)
    vp = paged_gather_ref(v_pool, table, lp)
    kt = paged_gather_ref(kt_pool, t_table, tcap)
    vt = paged_gather_ref(vt_pool, t_table, tcap)
    if k_scale is not None:
        kp = _dequant(kp, paged_gather_ref(k_scale, table, lp))
        vp = _dequant(vp, paged_gather_ref(v_scale, table, lp))
        kt = _dequant(kt, paged_gather_ref(kt_scale, t_table, tcap))
        vt = _dequant(vt, paged_gather_ref(vt_scale, t_table, tcap))
    return tree_attention_ref(q, kp, vp, kt, vt, tree_mask, past_len,
                              scale=scale)
