"""Grouped-query attention (with or without QKV bias) and multi-head
latent attention (MLA, DeepSeek-V2), with KV caches and the two-level
(model + tree) cache path of paper Algorithm 1, and the encoder's
bidirectional attention and the decoder's cross-attention of the
encoder-decoder family: the port of the JAX package's
``repro/models/attention.py``.

Shapes follow the JAX package: x [B, S, d_model], q [B, S, H, hd],
k/v [B, S, KV, hd], caches ``{"k", "v"}`` of [B, L, KV, hd] per layer.
An int8 model (``cfg.quant == "int8"``) keeps int8 ``k``/``v`` [B, L, KV,
hd] and fp32 ``k_scale``/``v_scale`` [B, L, KV], one scale per row; fresh
rows are quantized as they are written, and the kernels run in their int8
mode on the cache and its scales.  Its projections are ``QuantWeight``s.

All three attention call sites go through the port's kernels
(``kernels.ops``): causal prefill and decode through
``flash_attention_lse``, tree verification through ``flash_attention_lse``
over the committed prefix plus ``tree_block_attention`` over the tree
buffer, merged by ``combine_lse``.  The kernels read the caches in place
through transposed views.  The kernels have no backward, so training
attends in plain PyTorch under autograd (``attn_train``), as the JAX
package's training forward attends in plain ``jnp``: ``gqa_attend`` under
a causal mask, or ``chunked_causal_attend`` from
``CHUNKED_ATTN_THRESHOLD`` keys on.  The pipeline ring's chunked prefill
(``attn_prefill_chunk``) attends through the flash kernel too, over the
cache rows earlier chunks wrote (the reference attends there in plain
``jnp``): a chunk's queries get the key chunks a one-shot causal prefill
gives them (``flash.chunk_plan``).  The encoder's self-attention
(``attn_bidir``) and the cross-attention (``cross_attn_forward``) attend
through the flash kernel too, with no mask (``ops.full_attention``),
where the reference attends in plain ``jnp``; in training the
cross-attention is plain ``gqa_attend``.

A cache leaf may also be block-paged (``models.paging.Paged``: a row pool
behind a per-slot block table, the SpecPipe-DB paged arena).  Then decode
and tree verification take the paged kernels (``ops.paged_*``), which read
the pools through the tables as strided ``[Nb, KV, page, hd]`` views, with
no dense copy; int8 scale leaves are paged like K/V and share the table.

Caches are updated in place (the JAX functions return new arrays): a
cache is a preallocated buffer that each write fills at given rows, which
keeps one copy of every cache on the card.  Dense writes are checked on
the host to fit; nothing is clamped or dropped.  Paged writes follow the
reference's drop semantics: rows past the buffer end land in the null
block.

MLA (``MLAttention``) caches the compressed rows ``{"c_kv", "k_rope"}``
and attends in plain PyTorch in every mode, as the reference does (its
kernel paths require ``cfg.mla is None``): expanded per-head K/V under one
joint softmax for a prompt, a chunk and a tree layer, and the absorbed
form for decode.  Its caches page like K/V.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models import paging
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QuantWeight, apply_rope, dense_init_,
                                       param, weight, wide)


class Attention(nn.Module):
    """GQA projections: w_q [d,H,hd], w_k/w_v [d,KV,hd], w_o [H,hd,d]; int8
    ``QuantWeight``s when ``cfg.quant == "int8"``.  With ``cfg.qkv_bias``
    (Qwen) also fp32 biases b_q [H,hd], b_k/b_v [KV,hd], added after the
    projections and before RoPE (fp32 in an int8 model too)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.num_heads, cfg.num_kv_heads
        quant = cfg.quant == "int8"
        self.w_q = weight((d, h, hd), 1, quant, device)
        self.w_k = weight((d, kv, hd), 1, quant, device)
        self.w_v = weight((d, kv, hd), 1, quant, device)
        self.w_o = weight((h, hd, d), 2, quant, device)
        if cfg.qkv_bias:
            self.b_q = param((h, hd), device)
            self.b_k = param((kv, hd), device)
            self.b_v = param((kv, hd), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """LeCun normal weights (w_o's fan-in is the head dim, as in JAX);
        zero biases."""
        d, _, hd = self.w_q.shape
        for w in (self.w_q, self.w_k, self.w_v):
            dense_init_(w, d, gen)
        dense_init_(self.w_o, hd, gen)
        for name in ("b_q", "b_k", "b_v"):
            if hasattr(self, name):
                getattr(self, name).zero_()


class MLAttention(nn.Module):
    """Multi-head latent attention (DeepSeek-V2), fp32: w_dq [d,rq] and
    w_q [rq,H,nope+rope] (or w_q [d,H,nope+rope] without a q low rank),
    w_dkv [d,r], w_kr [d,rope], w_ukv [r,H,nope+v], w_o [H,v,d].  The
    caches keep the compressed rows (``c_kv`` [B,L,r], ``k_rope``
    [B,L,rope]); attention runs in plain PyTorch, as in the reference."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        if m.q_lora_rank:
            self.w_dq = param((d, m.q_lora_rank), device)
            self.w_q = param((m.q_lora_rank, h, qd), device)
        else:
            self.w_q = param((d, h, qd), device)
        self.w_dkv = param((d, m.kv_lora_rank), device)
        self.w_kr = param((d, m.qk_rope_head_dim), device)
        self.w_ukv = param((m.kv_lora_rank, h,
                            m.qk_nope_head_dim + m.v_head_dim), device)
        self.w_o = param((h, m.v_head_dim, d), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """LeCun normal weights over each weight's input axis (w_o's is the
        value head dim, as in JAX)."""
        for name, w in self.named_parameters(recurse=False):
            dense_init_(w, w.shape[1] if name == "w_o" else w.shape[0], gen)


def _proj(x, w):
    """x [B,S,d] @ w [d,heads,hd] -> [B,S,heads,hd]."""
    if isinstance(w, QuantWeight):
        return ops.quant_matmul(x, w.q8, w.scale)
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(p, out):
    """Attention output [B,S,H,hd] through w_o -> [B,S,d]."""
    if isinstance(p.w_o, QuantWeight):
        return ops.quant_matmul(out, p.w_o.q8, p.w_o.scale)
    return out.flatten(-2) @ p.w_o.reshape(-1, p.w_o.shape[-1])


def project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    """q [B,S,H,hd], k/v [B,S,KV,hd]: the biases (when the model has them)
    added, then RoPE applied to q and k."""
    q, k, v = _proj(x, p.w_q), _proj(x, p.w_k), _proj(x, p.w_v)
    if cfg.qkv_bias:
        q, k, v = q + p.b_q, k + p.b_k, v + p.b_v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_attend(q, k, v, mask, *, scale: Optional[float] = None):
    """Reference GQA over explicit masks, with the JAX ``gqa_attend`` fill
    (the fp32 minimum): q [B,Sq,H,hd], k/v [B,Sk,KV,hd], mask
    [B|1, 1, Sq, Sk] bool.  Serving runs the kernels instead (this is the
    semantics they are held to); training attends through it."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, rep, hd)
    logits = wide(torch.einsum("bqgrk,bsgk->bgrqs", qg, k)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, :, None],
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqs,bsgk->bqgrk", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


# full-sequence training attention switches to the chunked (memory-
# efficient) form at this sequence length: logits temporaries become
# [B, H, CHUNK_Q, S] instead of [B, H, S, S]
CHUNKED_ATTN_THRESHOLD = 2048
CHUNK_Q = 1024


def causal_mask(sq: int, sk: int, q_offset, window: int = 0, device=None):
    """[1, 1, Sq, Sk] bool: query i (absolute ``q_offset + i``) attends key
    j if j <= i, and within ``window`` if window > 0."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None]


def _causal_chunk(qc, k, v, start: int, window: int, scale: float):
    """Causal attention of the queries at rows [start, start + len(qc))."""
    mask = causal_mask(qc.shape[1], k.shape[1], start, window, qc.device)
    return gqa_attend(qc, k, v, mask, scale=scale)


def chunked_causal_attend(q, k, v, *, window: int = 0,
                          scale: Optional[float] = None):
    """Causal attention over query chunks of ``CHUNK_Q`` rows, each
    recomputed in backward (``torch.utils.checkpoint``): the math of
    ``gqa_attend`` under ``causal_mask``, with O(S * CHUNK_Q) temporaries.
    q [B,S,H,hd], k/v [B,S,KV,hd]."""
    b, s, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cq = min(CHUNK_Q, s)
    pad = (-s) % cq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [checkpoint(_causal_chunk, q[:, c:c + cq], k, v, c, window,
                       scale, use_reentrant=False)
            for c in range(0, s + pad, cq)]
    return torch.cat(outs, dim=1)[:, :s]


# --------------------------------------------------------------------------
# KV caches
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeroed fp32 {"k", "v"} [batch, max_len, KV, hd]; for an int8 model,
    int8 {"k", "v"} and fp32 {"k_scale", "v_scale"} [batch, max_len, KV];
    for MLA, fp32 {"c_kv" [batch, max_len, r], "k_rope" [batch, max_len,
    rope]}."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                      device=device)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], device=device),
                "v_scale": torch.zeros(shape[:3], device=device)}
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def kv_updates(cache, k, v):
    """The rows a K/V write puts in ``cache``: ``k``/``v`` as they are, or,
    for an int8 cache, their int8 values and per-row scales, so that the
    values and their scales land in the same write."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def write_index(buf, starts: Sequence[int], b: int, n: int, *, on=None,
                drop: bool = False):
    """Where a write of ``n`` rows per batch row at ``starts`` (one start
    broadcasts over ``b`` rows) lands in cache leaf ``buf``: the physical
    pool rows [b, n] of a paged leaf (``paging.len_rows``; rows past the
    end and rows of batch rows with ``on[b]`` False go to the null block),
    None for a dense write at one start (a slice), else the rows [b, n] of
    a dense leaf on its device, checked on the host to fit.

    With a row mask ``on`` (host bools [b]) or ``drop``, a dense write
    keeps only the rows of batch rows that are on and, with ``drop``, that
    lie inside the buffer (the reference's drop semantics at the
    ``max_len`` edge): the index is then the (batch, row, source) triple
    of the kept rows, built on the host.  The leaves of one cache share
    it."""
    rows = list(starts) * b if len(starts) == 1 else list(starts)
    if paging.is_paged(buf):
        return paging.len_rows(buf, rows, n, on)
    length = buf.shape[1]
    if len(rows) != b:
        raise IndexError(f"cache write of {n} rows at {rows} for {b} "
                         "batch rows")
    if on is not None or drop:
        keep = np.ones((b, n), bool) if on is None else np.repeat(
            np.asarray(on, bool).reshape(b, 1), n, axis=1)
        pos = np.asarray(rows, np.int64)[:, None] + np.arange(n)
        if not drop and keep.any() and (pos[keep].min() < 0
                                        or pos[keep].max() >= length):
            raise IndexError(f"cache write of {n} rows at {rows} does not "
                             f"fit {length} rows")
        keep &= (pos >= 0) & (pos < length)
        bi, ji = np.nonzero(keep)
        return tuple(torch.as_tensor(a, device=buf.device) for a in (
            bi, pos[bi, ji], bi * n + ji))
    if min(rows) < 0 or max(rows) + n > length:
        raise IndexError(f"cache write of {n} rows at {rows} does not "
                         f"fit {length} rows")
    if len(set(rows)) == 1:
        return None
    return torch.as_tensor(rows, device=buf.device)[:, None] + \
        torch.arange(n, device=buf.device)


def cache_write_rows(cache, updates, starts: Sequence[int], *,
                     index=None, on=None, drop: bool = False):
    """Per-row write: batch row b of every update lands at rows
    [starts[b], starts[b]+n) (one start broadcasts), in place.  ``on``
    (host bools [b]) leaves the rows of the batch rows that are off
    untouched; ``drop`` drops rows past the buffer's end instead of
    refusing the write.  ``index`` is the leaves' shared ``write_index``
    (given with the same ``on``/``drop``), computed here when not given
    (a caller writing every layer's cache at the same rows computes it
    once)."""
    first = next(iter(updates))
    b, n = updates[first].shape[:2]
    if index is None:
        index = write_index(cache[first], starts, b, n, on=on, drop=drop)
    for name, u in updates.items():
        buf = cache[name]
        if paging.is_paged(buf):
            paging.write_len_rows(buf, u, None, rows=index)
        elif isinstance(index, tuple):
            bi, ri, src = index
            buf[bi, ri] = u.reshape(b * n, *u.shape[2:])[src].to(buf.dtype)
        elif index is None:
            s0 = int(starts[0])
            buf[:, s0:s0 + n] = u
        else:
            buf[torch.arange(b, device=buf.device)[:, None], index] = u
    return cache


def _heads_first(t):
    """[B,S,heads,hd] -> a [B,heads,S,hd] view (no copy); [B,S,heads]
    scales -> [B,heads,S]."""
    return t.transpose(1, 2)


def _scales(cache, k: str = "k_scale", v: str = "v_scale"):
    """The kernels' int8 keywords for an int8 cache (scale views in the
    kernels' [B,KV,L] layout, or [Nb,KV,page] pool views for a paged
    cache), nothing for an fp32 one."""
    if "k_scale" not in cache:
        return {}
    return {k: _kernel_view(cache["k_scale"]),
            v: _kernel_view(cache["v_scale"])}


def _kernel_view(buf):
    """A cache leaf as the kernels read it: [B,heads,L,...] for a dense
    leaf, the [Nb,heads,page,...] pool view for a paged one (no copy)."""
    if paging.is_paged(buf):
        return paging.pool_view(buf.pages, buf.page)
    return _heads_first(buf)


# --------------------------------------------------------------------------
# multi-head latent attention (DeepSeek-V2), plain PyTorch as in the
# reference: a prompt, a chunk and a tree layer attend over the cache's
# compressed rows expanded to per-head K/V (joint softmax); decode attends
# in the compressed space (the reference's absorbed form, W_uk folded into
# q and W_uv applied after), which sums in another order
# --------------------------------------------------------------------------
def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope), rounded as the reference computes it (fp32
    square root and division)."""
    m = cfg.mla
    qd = torch.tensor(float(m.qk_nope_head_dim + m.qk_rope_head_dim))
    return float(1.0 / torch.sqrt(qd))


def _raw(buf):
    """A cache leaf's dense [B, L, ...] rows (a paged leaf gathered through
    its table)."""
    return paging.to_dense(buf) if paging.is_paged(buf) else buf


def _mla_rows(p: MLAttention, cfg: ModelConfig, x, positions):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope], cache rows {"c_kv"
    [B,S,r], "k_rope" [B,S,rope]}) of x at ``positions``; RoPE on q_rope
    and on the single-head k_rope."""
    m = cfg.mla
    xq = x @ p.w_dq if hasattr(p, "w_dq") else x
    q = _proj(xq, p.w_q)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope((x @ p.w_kr)[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, {"c_kv": x @ p.w_dkv, "k_rope": k_rope}


def _mla_expand(p: MLAttention, cfg: ModelConfig, rows):
    """Per-head k [B,L,H,nope+rope] and v [B,L,H,v] of compressed rows
    (k_rope shared by every head)."""
    m = cfg.mla
    kv = _proj(_raw(rows["c_kv"]), p.w_ukv)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    kr = _raw(rows["k_rope"])[:, :, None, :].expand(*k_nope.shape[:3], -1)
    return torch.cat([k_nope, kr], -1), v


def _mla_attend(p: MLAttention, cfg: ModelConfig, q_nope, q_rope, k, v,
                mask):
    """Joint softmax of the expanded form, through w_o: [B,S,d]."""
    out = gqa_attend(torch.cat([q_nope, q_rope], -1), k, v, mask,
                     scale=_mla_scale(cfg))
    return _out(p, out)


def _mla_absorbed(p: MLAttention, cfg: ModelConfig, q_nope, q_rope, cache,
                  valid):
    """Decode attention in the compressed space: q_* [B,n,H,*] against the
    cache's c_kv [B,L,r] and k_rope [B,L,rope] under ``valid`` [B,1,n,L]
    (masked logits take the fp32 minimum, as in the reference).  Returns
    [B,n,H,v]."""
    m = cfg.mla
    c_kv, k_rope = _raw(cache["c_kv"]), _raw(cache["k_rope"])
    w_uk = p.w_ukv[..., :m.qk_nope_head_dim]          # [r,H,nope]
    w_uv = p.w_ukv[..., m.qk_nope_head_dim:]          # [r,H,v]
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    lo = (torch.einsum("bqhr,bsr->bhqs", q_eff, c_kv)
          + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
    lo = wide(lo) * _mla_scale(cfg)
    lo = lo.masked_fill(~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(lo, dim=-1).to(c_kv.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)
    return torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)


def _mla_causal(p: MLAttention, cfg: ModelConfig, q_nope, q_rope, k, v,
                window: int):
    """Causal attention of a whole sequence in the expanded form (chunked
    from ``CHUNKED_ATTN_THRESHOLD`` keys on), through w_o."""
    q = torch.cat([q_nope, q_rope], -1)
    s = q.shape[1]
    if s >= CHUNKED_ATTN_THRESHOLD:
        out = chunked_causal_attend(q, k, v, window=window,
                                    scale=_mla_scale(cfg))
    else:
        out = gqa_attend(q, k, v, causal_mask(s, s, 0, window, q.device),
                         scale=_mla_scale(cfg))
    return _out(p, out)


def _key_bound(length: int, positions, window: int, device):
    """[B,1,n,L] bool: key j at or before each query's position (and
    within ``window``)."""
    kpos = torch.arange(length, device=device)[None, None, None, :]
    qp = positions[:, None, :, None]
    valid = kpos <= qp
    if window:
        valid &= kpos > qp - window
    return valid


@dataclasses.dataclass
class EmptyRows:
    """The batch rows of a tree verify with no committed prefix, and what
    every layer needs to give their keyless queries the reference's value
    (``_empty_row_value``), built once a verify by ``empty_rows`` so that
    the layers copy nothing from the host.

    ``slots``   [E] int64, the batch rows with ``model_len`` 0;
    ``queries`` [E, n] bool, which of their queries have an all-false mask;
    ``past``, ``tree`` [E, L], [E, T] int64, the physical pool rows of
                those batch rows in a paged model or tree cache (None for
                a dense one);
    ``src``     [E, T] int64, the layer's row that lands at tree row t;
    ``new``     [E, T] bool, whether tree row t takes a row of the layer
                (the layer's rows past the buffer's end are dropped).
    """
    slots: torch.Tensor
    queries: torch.Tensor
    past: Optional[torch.Tensor]
    tree: Optional[torch.Tensor]
    src: torch.Tensor
    new: torch.Tensor


def empty_rows(slots: Sequence[int], tree_mask, model_cache, tree_cache,
               tree_write_index: Sequence[int]) -> EmptyRows:
    """``EmptyRows`` of batch rows ``slots`` (host ints) for a tree layer
    of ``tree_mask`` [B,n,T] written at ``tree_write_index`` (host ints,
    one broadcasts), over one layer's caches (every layer of a model
    shares their tables and shapes)."""
    dev = tree_mask.device
    n, t = tree_mask.shape[1:]
    idx = torch.tensor(list(slots), device=dev)
    starts = list(tree_write_index)
    starts = [starts[0 if len(starts) == 1 else s] for s in slots]
    rel = (torch.arange(t, device=dev)
           - torch.tensor(starts, device=dev)[:, None])

    def phys(buf):
        if not paging.is_paged(buf):
            return None
        return paging.row_ids(paging.Paged(buf.pages, buf.table[idx],
                                           buf.page, buf.length))
    return EmptyRows(idx, ~tree_mask[idx].any(-1), phys(model_cache["v"]),
                     phys(tree_cache["v"]), rel.clamp(0, n - 1),
                     (rel >= 0) & (rel < n))


def _rows_v(cache, slots, rows):
    """The V rows of batch rows ``slots`` as fp32 [E, L, KV, hd]: a paged
    leaf read at its physical ``rows`` [E, L], int8 rows times their
    scales."""
    def pick(buf):
        return buf.pages[rows] if rows is not None else buf[slots]
    v = pick(cache["v"])
    return v.float() * pick(cache["v_scale"])[..., None] \
        if "v_scale" in cache else v


def _empty_row_value(model_cache, tree_cache, rows, empty: EmptyRows,
                     rep: int):
    """[E,H,1,hd]: what the reference's joint softmax over [past || tree]
    gives a query of an ``empty`` batch row with no valid key (every logit
    at the fp32 minimum, so uniform weights): the mean of V over all past
    and tree rows of that batch row, per KV head, for each of the ``rep``
    heads sharing it.  The tree rows are read as they stand before this
    layer's write (``tree_cache``), with the layer's ``rows`` put at their
    logical places: the reference writes into its dense view of a paged
    arena, so an unallocated block holds the layer's rows there too."""
    layer = _rows_v(rows, empty.slots, None)              # [E,n,KV,hd]
    tree = torch.where(
        empty.new[:, :, None, None],
        torch.take_along_dim(layer, empty.src[:, :, None, None], dim=1),
        _rows_v(tree_cache, empty.slots, empty.tree))
    past = _rows_v(model_cache, empty.slots, empty.past)
    mean = torch.cat([past, tree], 1).mean(1)             # [E,KV,hd]
    return mean.repeat_interleave(rep, dim=1)[:, :, None]


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def attn_forward(p: Attention, cfg: ModelConfig, x, positions, *,
                 cache=None, window: int = 0):
    """Causal attention over a whole prompt (prefill); fills ``cache`` rows
    [0, S) when given.  positions [B,S].  Returns (out [B,S,d], cache).

    With an int8 cache the prompt attends the same quantized rows the
    cache keeps (the quantize-dequantize round trip of its own K/V, as in
    the reference), through the flash kernel's int8 mode, so that a
    prompt read back from the cache later sees the same values.  MLA
    caches the compressed rows and attends in plain PyTorch."""
    if isinstance(p, MLAttention):
        q_nope, q_rope, rows = _mla_rows(p, cfg, x, positions)
        if cache is not None:
            cache_write_rows(cache, rows, [0])
        k, v = _mla_expand(p, cfg, rows)
        return _mla_causal(p, cfg, q_nope, q_rope, k, v, window), cache
    q, k, v = project_qkv(p, cfg, x, positions)
    kw = {}
    if cache is not None:
        rows = kv_updates(cache, k, v)
        cache_write_rows(cache, rows, [0])
        k, v = rows["k"], rows["v"]
        kw = _scales(rows)
    out = ops.prefill_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), positions, window=window,
                                **kw)
    return _out(p, _heads_first(out)), cache


def attn_bidir(p: Attention, cfg: ModelConfig, x, positions, *,
               train: bool = False):
    """Bidirectional self-attention of a whole sequence (the encoder's):
    RoPE at ``positions`` [B,S], every query over every key, through the
    flash kernel (``ops.full_attention``), or, with ``train``, plain
    ``gqa_attend`` with no mask under autograd (the reference's
    ``attn_forward(causal=False)``).  Returns out [B,S,d]."""
    q, k, v = project_qkv(p, cfg, x, positions)
    if train:
        return _out(p, gqa_attend(q, k, v, None))
    out = ops.full_attention(_heads_first(q), _heads_first(k),
                             _heads_first(v))
    return _out(p, _heads_first(out))


def encode_cross_kv(p: Attention, cfg: ModelConfig, enc_out):
    """Cross-attention (k, v) [B,T,KV,hd] of the encoder output
    ``enc_out`` [B,T,d]: the projections alone (no bias, no RoPE), as in
    the reference."""
    return _proj(enc_out, p.w_k), _proj(enc_out, p.w_v)


def cross_attn_forward(p: Attention, cfg: ModelConfig, x, enc_kv, *,
                       train: bool = False):
    """Decoder cross-attention of x [B,S,d] over ``enc_kv`` = (k, v)
    [1|B,T,KV,hd] (``encode_cross_kv``): no RoPE, no mask, the default
    1/sqrt(hd) scale.  A size-1 batch of K/V serves every row of x (the
    one encoder output of a SpecPipe-DB bundle over the bucket's rows).
    Through the flash kernel, or, with ``train``, plain ``gqa_attend``
    under autograd.  Returns [B,S,d]."""
    q = _proj(x, p.w_q)
    k, v = enc_kv
    if train:
        b = q.shape[0]
        out = gqa_attend(q, k.expand(b, *k.shape[1:]),
                         v.expand(b, *v.shape[1:]), None)
    else:
        out = _heads_first(ops.full_attention(
            _heads_first(q), _heads_first(k), _heads_first(v)))
    return _out(p, out)


def attn_train(p: Attention, cfg: ModelConfig, x, positions, *,
               window: int = 0):
    """Causal attention over a whole sequence for training, under autograd
    and without the kernels: ``gqa_attend`` under ``causal_mask`` below
    ``CHUNKED_ATTN_THRESHOLD`` keys, ``chunked_causal_attend`` from there
    on.  positions [B,S].  Returns out [B,S,d]."""
    if isinstance(p, MLAttention):
        q_nope, q_rope, rows = _mla_rows(p, cfg, x, positions)
        k, v = _mla_expand(p, cfg, rows)
        return _mla_causal(p, cfg, q_nope, q_rope, k, v, window)
    q, k, v = project_qkv(p, cfg, x, positions)
    s = x.shape[1]
    if s >= CHUNKED_ATTN_THRESHOLD:
        out = chunked_causal_attend(q, k, v, window=window)
    else:
        out = gqa_attend(q, k, v, causal_mask(s, s, 0, window, x.device))
    return _out(p, out)


def attn_prefill_chunk(p: Attention, cfg: ModelConfig, x, positions, cache,
                       chunk_start: Sequence[int], *, window: int = 0,
                       on=None):
    """One prefill chunk against the model cache (chunked prefill in the
    pipeline ring).

    x [B,s,d] holds chunk rows at absolute ``positions`` [B,s] (device)
    ``= chunk_start[b] + i`` (host ints).  The chunk's K/V rows are
    written into the cache first (rows past the cache's end dropped, batch
    rows whose ``on[b]`` is False left untouched), then the queries attend
    causally over the cache's rows [0, chunk_start[b] + s) through the
    flash kernel (``ops.chunk_attention``, int8 K/V in its int8 mode):
    chunk c sees the rows earlier chunks wrote, so streaming a prompt in
    chunks caches the rows a one-chunk pass caches.  The cache is dense:
    the ring densifies a paged arena around its ticks.  Returns (out
    [B,s,d], cache)."""
    if paging.any_paged(cache):
        raise ValueError("attn_prefill_chunk takes a dense cache: densify "
                         "a paged arena first (paging.densify)")
    if isinstance(p, MLAttention):
        q_nope, q_rope, rows = _mla_rows(p, cfg, x, positions)
        cache_write_rows(cache, rows, chunk_start, on=on, drop=True)
        k, v = _mla_expand(p, cfg, cache)
        valid = _key_bound(k.shape[1], positions, window, x.device)
        return _mla_attend(p, cfg, q_nope, q_rope, k, v, valid), cache
    q, k, v = project_qkv(p, cfg, x, positions)
    cache_write_rows(cache, kv_updates(cache, k, v), chunk_start, on=on,
                     drop=True)
    s, length = x.shape[1], cache["k"].shape[1]
    kv_len = torch.tensor([min(int(c) + s, length) for c in chunk_start],
                          dtype=torch.int32, device=x.device)
    out = ops.chunk_attention(_heads_first(q), _heads_first(cache["k"]),
                              _heads_first(cache["v"]), kv_len, positions,
                              window=window, **_scales(cache))
    return _out(p, _heads_first(out)), cache


def attn_decode(p: Attention, cfg: ModelConfig, x, position, cache,
                cache_len: Sequence[int], kv_len, *, window: int = 0):
    """One-token decode: x [B,1,d] at ``position`` [B] (device); the new
    K/V row lands at ``cache_len[b]`` (host ints) and the token attends
    ``kv_len`` [B] = cache_len + 1 rows per batch row.  MLA attends in
    the compressed space (``_mla_absorbed``)."""
    if isinstance(p, MLAttention):
        q_nope, q_rope, rows = _mla_rows(p, cfg, x, position[:, None])
        cache_write_rows(cache, rows, cache_len)
        c_kv = cache["c_kv"]
        length = c_kv.length if paging.is_paged(c_kv) else c_kv.shape[1]
        valid = _key_bound(length, position[:, None], window, x.device)
        out = _mla_absorbed(p, cfg, q_nope, q_rope, cache, valid)
        return _out(p, out), cache
    q, k, v = project_qkv(p, cfg, x, position[:, None])
    cache_write_rows(cache, kv_updates(cache, k, v), cache_len)
    if paging.is_paged(cache["k"]):
        out = ops.paged_decode_attention(
            _heads_first(q), _kernel_view(cache["k"]),
            _kernel_view(cache["v"]), cache["k"].table, kv_len,
            window=window, **_scales(cache))
    else:
        out = ops.decode_attention(_heads_first(q), _heads_first(cache["k"]),
                                   _heads_first(cache["v"]), kv_len,
                                   window=window, **_scales(cache))
    return _out(p, _heads_first(out)), cache


def attn_tree_verify(p: Attention, cfg: ModelConfig, x, positions, *,
                     model_cache, model_len, tree_cache,
                     tree_write_index: Sequence[int], tree_mask,
                     window: int = 0, tree_write_rows=None,
                     empty: Optional[EmptyRows] = None):
    """Attention for one new tree layer (paper Algorithm 1).

    x [B,n,d] the layer's hidden states at ``positions`` [B,n]; model_cache
    holds ``model_len`` [B] (device int32) committed rows per batch row; the
    layer's K/V land in ``tree_cache`` at ``tree_write_index[b]`` (host
    ints, or their ``write_index`` as ``tree_write_rows``); tree_mask
    [B,n,T] is each node's ancestor-or-self mask against the whole tree
    buffer.  Paged caches (both, as the paged arena keeps
    them) go through the paged kernels.  MLA attends in plain PyTorch
    over both caches expanded, one joint softmax, as the reference does.

    ``empty`` (``EmptyRows``, None when no row has ``model_len`` 0) marks
    the batch rows with no committed prefix and which of their queries
    have no valid key (an all-false mask): an empty slot's rows in a
    SpecPipe-DB bucket.  The kernels give such a query 0; the reference's
    joint softmax at the fp32 minimum gives it uniform weights, the mean
    of V over the row's ``max_len`` past rows and ``T`` tree rows
    (``_empty_row_value``), and that row reaches a MoE router beside the
    live rows.  So the GQA branch selects that value for the marked
    queries, reading only those batch rows' V, as the reference reads
    them: a paged cache through its table (the reference densifies),
    int8 rows dequantized.  MLA's joint softmax needs no select.
    Returns (out [B,n,d], tree_cache).
    """
    if isinstance(p, MLAttention):
        q_nope, q_rope, rows = _mla_rows(p, cfg, x, positions)
        cache_write_rows(tree_cache, rows, tree_write_index,
                         index=tree_write_rows)
        k_past, v_past = _mla_expand(p, cfg, model_cache)
        k_tree, v_tree = _mla_expand(p, cfg, tree_cache)
        b, n = positions.shape
        kpos = torch.arange(k_past.shape[1], device=x.device)
        past = (kpos[None, None, None, :]
                < model_len.long()[:, None, None, None])
        if window:
            past = past & (kpos > positions[:, None, :, None] - window)
        mask = torch.cat([past.expand(b, 1, n, k_past.shape[1]),
                          tree_mask[:, None]], -1)
        out = _mla_attend(p, cfg, q_nope, q_rope,
                          torch.cat([k_past, k_tree], 1),
                          torch.cat([v_past, v_tree], 1), mask)
        return out, tree_cache
    q, k, v = project_qkv(p, cfg, x, positions)
    rows = kv_updates(tree_cache, k, v)
    v_empty = None if empty is None else _empty_row_value(
        model_cache, tree_cache, rows, empty,
        cfg.num_heads // cfg.num_kv_heads)
    cache_write_rows(tree_cache, rows, tree_write_index,
                     index=tree_write_rows)
    kw = dict(window=window, qpos=positions, **_scales(model_cache),
              **_scales(tree_cache, "kt_scale", "vt_scale"))
    if paging.is_paged(model_cache["k"]):
        out = ops.paged_tree_attention(
            _heads_first(q), _kernel_view(model_cache["k"]),
            _kernel_view(model_cache["v"]), model_cache["k"].table,
            _kernel_view(tree_cache["k"]), _kernel_view(tree_cache["v"]),
            tree_cache["k"].table, tree_mask, model_len, **kw)
    else:
        out = ops.tree_attention(
            _heads_first(q), _heads_first(model_cache["k"]),
            _heads_first(model_cache["v"]), _heads_first(tree_cache["k"]),
            _heads_first(tree_cache["v"]), tree_mask, model_len, **kw)
    if v_empty is not None:
        out[empty.slots] = torch.where(empty.queries[:, None, :, None],
                                       v_empty, out[empty.slots])
    return _out(p, _heads_first(out)), tree_cache
