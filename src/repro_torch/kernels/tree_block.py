"""Tree-buffer attention block: CUDA kernel + plain twin.

Replaces the JAX package's Pallas kernel ``repro/kernels/tree_block.py``
(``tree_block_attention``): the n queries of one tree layer attend the
whole tree KV buffer under each row's ancestor-or-self mask, and the
result comes back with its softmax stats ``(m, l)`` for an exact merge
with the committed-prefix half (``combine_lse``).  Given that half
(``past=(o, m, l)``, what ``flash_attention_lse`` returned), the wrapper
returns the two halves merged instead: on the card the kernel's epilogue
merges them, so a tree-verify layer is two launches.

Layouts follow the JAX function: ``q [B,H,n,hd]``, ``k/v_tree
[B,KV,T,hd]`` (views of the port's ``[B,T,KV,hd]`` tree caches, read by
stride), ``tree_mask [n,T]`` or per-row ``[B,n,T]`` bool.  Stats are
``[B,H,n]``.  int8 mode: ``k_scale``/``v_scale`` ``[B,KV,T]`` fp32 mark
the tree K/V as per-row symmetric int8, dequantized as they are staged
(see ``flash``).

What bounds the kernel on an H100: at the main path's sizes (B = 1, T =
105 at 8 stages) a CTA's serial chain, not the bytes.  The kernel
(``csrc/tree_block_attention.cu``) stages a (batch row, KV head) slice of
the tree buffer in one asynchronous wave (``wave_keys``; a longer buffer
in double-buffered stages), splits its keys across the 8 warps of a CTA
of 16 (query, head) rows, each with its own running softmax, runs QK^T and
PV on the tensor cores in 3xTF32, and merges the warps' (acc, m, l) in
warp order (``flash.merge_chunks`` is the same arithmetic).
``tree_plan`` states the kernel's plan in plain Python, as a
specification: it depends on T and head_dim alone, so a row's bits do not
depend on B or on the rows that share its CTA.  The CPU tests check the
specification; the card tests hold the kernel to it (rows of a B = 3
call equal B = 1 calls, paged equals dense on the gathered view).  The
launch passes ``stage_keys`` alone: the kernel derives the rest.

Dispatch: a CPU tensor goes to ``tree_block_attention_plain``; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``launches`` and
``launches_int8`` on the wrapper count kernel launches in the fp32 and the
int8 mode; ``launches_hd256`` and ``launches_int8_hd256`` count those of
them that ran the head_dim 256 instance (Gemma).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.counting import bump_attr
from repro_torch.kernels import build
from repro_torch.kernels.flash import (MAX_HEAD_DIM, MIN_L, check_kv,
                                       dequant_kv, masked_softmax_lse,
                                       scale_args)

# The kernel's tile shape (kRows, kWarps in the source): (query, head) rows
# and warps a CTA.  16 x 8 was the fastest of (16 | 32) x (4 | 8) over the
# phase-2 tree cases, at both head_dims, fp32 and int8 (PERF.md).
ROWS, WARPS = 16, 8
# keys per softmax step of a warp (two 8-key MMA tiles)
BLOCK = 16

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# q and its strides, k, v and their strides, the scales and theirs, mask,
# the past half (o, m, l), the outputs (o, m, l), B, H, KV, n, T, hd,
# stage keys, scale, stream
_ARGTYPES = [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I64,
             _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P,
             _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P]


def wave_keys(hd: int) -> int:
    """The most tree rows a CTA stages in one wave: K and V of 128 keys at
    head_dim 128 (135 KB in fp32), 256 at 64, 64 at 256 (133 KB; 128 keys
    would take 266 KB, over the card's 227 KB a CTA)."""
    return 64 if hd > 128 else 128 if hd > 64 else 256


def stage_keys(t: int, hd: int) -> int:
    """Keys per stage: the whole buffer when it fits one wave, else half a
    wave per stage, double-buffered in the same shared memory."""
    return t if t <= wave_keys(hd) else wave_keys(hd) // 2


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """The kernel's plan for one T: ``stage_keys`` keys a stage, and per
    stage ``(t0, tl, ((lo, hi) per warp))``: the keys [lo, hi) each of the
    WARPS warps folds into its running softmax, in 16-key blocks."""
    stage_keys: int
    stages: tuple


def tree_plan(t: int, hd: int) -> TreePlan:
    """The plan of ``csrc/tree_block_attention.cu`` for a T-row buffer at
    head_dim ``hd``: a specification for the tests (the kernel computes the
    warps' shares itself from the stage keys it is given)."""
    sk = stage_keys(t, hd)
    stages = []
    for t0 in range(0, t, sk):
        tl = min(sk, t - t0)
        nblk = -(-tl // BLOCK)
        per = -(-nblk // WARPS)
        stages.append((t0, tl, tuple(
            (t0 + min(tl, BLOCK * s * per),
             t0 + min(tl, BLOCK * min(nblk, (s + 1) * per)))
            for s in range(WARPS))))
    return TreePlan(sk, tuple(stages))


def split_tf32(x: torch.Tensor):
    """The attention kernels' split of fp32 ``x`` into (big, small), both
    fp32 (``split_tf32`` in ``csrc/attn_common.cuh``): big keeps the top 10
    mantissa bits (a mask), small = x - big is exact.  The MMA reads an
    operand's top 19 bits, so it sees big whole and small truncated."""
    x = x.float()
    big = (x.view(torch.int32) & -8192).view(torch.float32)
    return big, x - big


def row_tiles(n: int, rep: int):
    """The CTAs of one (batch row, KV head): ``(r0, count)`` of the
    (query, head) rows ``r = query * rep + head`` each takes."""
    return [(r0, min(ROWS, n * rep - r0)) for r0 in range(0, n * rep, ROWS)]


def combine_lse(parts):
    """parts: list of (o [B,H,n,hd], m [B,H,n], l [B,H,n]), each ``o``
    normalised within its source.  Returns the joint-softmax result (the
    kernel's merge epilogue computes the same, step for step)."""
    m_all = torch.stack([m for _, m, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for o, m, l in parts:
        w = (l * torch.exp(m - m_all))[..., None]
        num = num + w * o.float()
        den = den + w
    return num / den.clamp_min(MIN_L)


def tree_block_attention_plain(q, k_tree, v_tree, tree_mask, *,
                               scale: float, k_scale=None, v_scale=None,
                               past=None):
    """Plain PyTorch version of the kernel; ``tree_mask`` bool [B,n,T];
    int8 K/V with their scales are dequantized first.  With ``past`` it
    returns ``combine_lse([past, (o, m, l)])``."""
    k_tree, v_tree = dequant_kv(k_tree, v_tree, k_scale, v_scale)
    b, h, n, hd = q.shape
    kvh = k_tree.shape[1]
    rep = h // kvh
    qs = (q.float() * scale).reshape(b, kvh, rep, n, hd)
    o, m, l = masked_softmax_lse(qs, k_tree, v_tree, tree_mask[:, None, None])
    tree = o.reshape(b, h, n, hd), m.reshape(b, h, n), l.reshape(b, h, n)
    return tree if past is None else combine_lse([past, tree])


def check_past(past, q):
    """Raise unless ``past`` is the committed-prefix half the kernel's
    epilogue reads: fp32 contiguous o [B,H,n,hd], m, l [B,H,n] on q's
    device.  Returns the three pointers."""
    o, m, l = past
    b, h, n, hd = q.shape
    for x, shape in ((o, (b, h, n, hd)), (m, (b, h, n)), (l, (b, h, n))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"past half must be fp32 contiguous {shape} on "
                             f"{q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return [o.data_ptr(), m.data_ptr(), l.data_ptr()]


def outputs(q, past):
    """The kernel's outputs: (o, m, l), or (merged o, None, None) with a
    past half."""
    b, h, n, hd = q.shape
    o = torch.empty((b, h, n, hd), dtype=torch.float32, device=q.device)
    if past is not None:
        return o, None, None
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    return o, m, torch.empty_like(m)


def _launch(q, k_tree, v_tree, mask, *, scale, k_scale, v_scale, past):
    b, h, n, hd = q.shape
    kvh, t = k_tree.shape[1], k_tree.shape[2]
    int8 = check_kv("tree_block_attention", k_tree, v_tree, k_scale,
                    v_scale)
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise TypeError("tree_block_attention kernel takes fp32 q with a "
                        "contiguous head dim")
    if h % kvh or hd > MAX_HEAD_DIM:
        raise ValueError(f"unsupported shape H={h} KV={kvh} hd={hd}")
    past_ptrs = [None] * 3 if past is None else check_past(past, q)
    o, m, l = outputs(q, past)
    fn = build.launcher("tree_block_attention", _ARGTYPES)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k_tree.data_ptr(), v_tree.data_ptr(), k_tree.stride(0),
             k_tree.stride(1), k_tree.stride(2),
             *scale_args(k_scale, v_scale), mask.data_ptr(), *past_ptrs,
             o.data_ptr(), None if m is None else m.data_ptr(),
             None if l is None else l.data_ptr(),
             b, h, kvh, n, t, hd, stage_keys(t, hd),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check("tree_block_attention", err)
    mode = "launches_int8" if int8 else "launches"
    bump_attr(tree_block_attention, mode)
    if hd > 128:     # the head_dim 256 instance (Gemma)
        bump_attr(tree_block_attention, mode + "_hd256")
    return o if past is not None else (o, m, l)


def tree_block_attention(q, k_tree, v_tree, tree_mask, *, k_scale=None,
                         v_scale=None, scale: Optional[float] = None,
                         past=None):
    """q [B,H,n,hd]; k/v_tree [B,KV,T,hd]; tree_mask [n,T] or [B,n,T] bool;
    k_scale/v_scale [B,KV,T] fp32 for int8 k/v_tree.

    Returns (o [B,H,n,hd], m [B,H,n], l [B,H,n]), all fp32; with ``past``
    = (o, m, l) of the committed-prefix half, the merged [B,H,n,hd] output
    ``combine_lse([past, (o, m, l)])`` instead.
    """
    b, h, n, hd = q.shape
    t = k_tree.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    mask = tree_mask if tree_mask.dim() == 3 else tree_mask[None]
    mask = mask.to(device=q.device, dtype=torch.bool).expand(b, n, t)
    # device dispatch is in two layers: the CPU here, meta tensors one
    # layer up in ``ops._tree`` (the dry run); this wrapper refuses meta
    if q.device.type == "cpu":
        return tree_block_attention_plain(q, k_tree, v_tree, mask,
                                          scale=scale, k_scale=k_scale,
                                          v_scale=v_scale, past=past)
    if q.device.type != "cuda":
        raise RuntimeError(f"no tree_block_attention for {q.device}")
    # a torch.bool buffer is one byte per entry, 0 or 1: the kernel's uint8
    return _launch(q, k_tree, v_tree, mask.contiguous(), scale=scale,
                   k_scale=k_scale, v_scale=v_scale, past=past)


tree_block_attention.launches = 0
tree_block_attention.launches_int8 = 0
tree_block_attention.launches_hd256 = 0
tree_block_attention.launches_int8_hd256 = 0
