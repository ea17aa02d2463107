"""Attention entry points of the port, composed from the two kernels.

``combine_lse`` merges partial attention results over disjoint KV sources
using their log-sum-exp stats: mathematically a joint softmax over the
concatenation (flash-decoding combination), which is how paper Algorithm
1's softmax(concat(S_past, S_predict)) is computed without materialising
the concatenation.

The device of the tensors picks the implementation: CUDA tensors launch
the kernels, CPU tensors take their plain versions (see ``flash`` and
``tree_block``).  There is no switch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash import flash_attention_lse, rows_i32
from repro_torch.kernels.tree_block import tree_block_attention

MIN_L = 1e-30


def combine_lse(parts):
    """parts: list of (o [B,H,n,hd], m [B,H,n], l [B,H,n]), each ``o``
    normalised within its source.  Returns the joint-softmax result."""
    m_all = torch.stack([m for _, m, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for o, m, l in parts:
        w = (l * torch.exp(m - m_all))[..., None]
        num = num + w * o.float()
        den = den + w
    return num / den.clamp_min(MIN_L)


def tree_attention(q, k_past, v_past, k_tree, v_tree, tree_mask, past_len,
                   *, scale: Optional[float] = None, window: int = 0,
                   qpos=None):
    """Two-level tree attention: the committed prefix (``past_len`` valid
    rows per batch row, optional sliding ``window`` against ``qpos``) and
    the tree buffer (ancestor mask ``[n,T]`` or ``[B,n,T]``), merged by
    ``combine_lse``.  q [B,H,n,hd]; k/v_past [B,KV,L,hd]; k/v_tree
    [B,KV,T,hd].  Returns [B,H,n,hd]."""
    past = flash_attention_lse(q, k_past, v_past, past_len, qpos,
                               scale=scale, window=window)
    tree = tree_block_attention(q, k_tree, v_tree, tree_mask, scale=scale)
    return combine_lse([past, tree]).to(q.dtype)


def decode_attention(q, k, v, kv_len, *, scale: Optional[float] = None,
                     window: int = 0):
    """Decode over a KV cache: q [B,H,n,hd] at position ``kv_len - 1`` of
    its batch row, k/v [B,KV,L,hd] with ``kv_len`` (int or [B]) valid
    rows.  Returns [B,H,n,hd]."""
    b, _, n, _ = q.shape
    kv = rows_i32(kv_len, b, q.device)
    qpos = (kv - 1)[:, None].expand(b, n)
    o, _, _ = flash_attention_lse(q, k, v, kv, qpos, scale=scale,
                                  window=window)
    return o.to(q.dtype)


def prefill_attention(q, k, v, positions, *, scale: Optional[float] = None,
                      window: int = 0):
    """Causal attention for prefill: q [B,H,S,hd], k/v [B,KV,S,hd],
    positions [S] or [B,S].  Returns [B,H,S,hd]."""
    o, _, _ = flash_attention_lse(q, k, v, k.shape[2], positions,
                                  scale=scale, window=window, causal=True)
    return o.to(q.dtype)
