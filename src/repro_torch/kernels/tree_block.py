"""Tree-buffer attention block: CUDA kernel + plain twin.

Replaces the JAX package's Pallas kernel ``repro/kernels/tree_block.py``
(``tree_block_attention``): the n queries of one tree layer attend the
whole tree KV buffer under each row's ancestor-or-self mask, and the
result comes back with its softmax stats ``(m, l)`` for an exact merge
with the committed-prefix half (``ops.combine_lse``).

Layouts follow the JAX function: ``q [B,H,n,hd]``, ``k/v_tree
[B,KV,T,hd]`` (views of the port's ``[B,T,KV,hd]`` tree caches, read by
stride), ``tree_mask [n,T]`` or per-row ``[B,n,T]`` bool.  Stats are
``[B,H,n]``.  int8 mode: ``k_scale``/``v_scale`` ``[B,KV,T]`` fp32 mark
the tree K/V as per-row symmetric int8, dequantized as each tile is
staged (see ``flash``).

What bounds the kernel on an H100: bytes, and at the main path's sizes
(B = 1, T = 105 at 8 stages) launch latency.  The Pallas kernel holds the
buffer in one VMEM tile; the CUDA kernel streams it through shared memory
in 32-row tiles with a running softmax, so T is not bounded by shared
memory, and splits the queries into tiles of at most 16 (query, head) rows
per CTA like ``flash``.  See ``csrc/tree_block_attention.cu``.

Dispatch: a CPU tensor goes to ``tree_block_attention_plain``; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``launches`` and
``launches_int8`` on the wrapper count kernel launches in the fp32 and the
int8 mode.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash import (check_kv, dequant_kv,
                                      masked_softmax_lse, scale_args)

# (query, head) rows per CTA: the kernel takes max(1, ROWS // rep) queries
# of all rep heads of a KV head per CTA (attn_common.cuh kMaxRows)
ROWS = 16

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
_ARGTYPES = [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I64,
             _P, _P, _I64, _I64, _I64, _P, _P, _P, _P,
             _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P]


def tree_block_attention_plain(q, k_tree, v_tree, tree_mask, *,
                               scale: float, k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel; ``tree_mask`` bool [B,n,T];
    int8 K/V with their scales are dequantized first."""
    k_tree, v_tree = dequant_kv(k_tree, v_tree, k_scale, v_scale)
    b, h, n, hd = q.shape
    kvh = k_tree.shape[1]
    rep = h // kvh
    qs = (q.float() * scale).reshape(b, kvh, rep, n, hd)
    o, m, l = masked_softmax_lse(qs, k_tree, v_tree, tree_mask[:, None, None])
    return o.reshape(b, h, n, hd), m.reshape(b, h, n), l.reshape(b, h, n)


def _launch(q, k_tree, v_tree, mask, *, scale, k_scale, v_scale):
    b, h, n, hd = q.shape
    kvh, t = k_tree.shape[1], k_tree.shape[2]
    int8 = check_kv("tree_block_attention", k_tree, v_tree, k_scale,
                    v_scale)
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise TypeError("tree_block_attention kernel takes fp32 q with a "
                        "contiguous head dim")
    if h % kvh or hd > 128 or h // kvh > ROWS:
        raise ValueError(f"unsupported shape H={h} KV={kvh} hd={hd}")
    o = torch.empty((b, h, n, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.launcher("tree_block_attention", _ARGTYPES)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k_tree.data_ptr(), v_tree.data_ptr(), k_tree.stride(0),
             k_tree.stride(1), k_tree.stride(2),
             *scale_args(k_scale, v_scale), mask.data_ptr(),
             o.data_ptr(), m.data_ptr(), l.data_ptr(),
             b, h, kvh, n, t, hd, max(1, ROWS // (h // kvh)), float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("tree_block_attention", err)
    if int8:
        tree_block_attention.launches_int8 += 1
    else:
        tree_block_attention.launches += 1
    return o, m, l


def tree_block_attention(q, k_tree, v_tree, tree_mask, *, k_scale=None,
                         v_scale=None, scale: Optional[float] = None):
    """q [B,H,n,hd]; k/v_tree [B,KV,T,hd]; tree_mask [n,T] or [B,n,T] bool;
    k_scale/v_scale [B,KV,T] fp32 for int8 k/v_tree.

    Returns (o [B,H,n,hd], m [B,H,n], l [B,H,n]), all fp32.
    """
    b, h, n, hd = q.shape
    t = k_tree.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    mask = tree_mask if tree_mask.dim() == 3 else tree_mask[None]
    mask = mask.to(device=q.device, dtype=torch.bool).expand(b, n, t)
    if q.device.type == "cpu":
        return tree_block_attention_plain(q, k_tree, v_tree, mask,
                                          scale=scale, k_scale=k_scale,
                                          v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no tree_block_attention for {q.device}")
    # a torch.bool buffer is one byte per entry, 0 or 1: the kernel's uint8
    return _launch(q, k_tree, v_tree, mask.contiguous(), scale=scale,
                   k_scale=k_scale, v_scale=v_scale)


tree_block_attention.launches = 0
tree_block_attention.launches_int8 = 0
