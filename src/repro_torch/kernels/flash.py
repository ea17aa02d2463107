"""Flash attention with log-sum-exp statistics: CUDA kernel + plain twin.

Replaces the JAX package's Pallas kernel ``repro/kernels/flash.py``
(``flash_attention_lse``).  One kernel serves three call sites: the
committed-prefix half of tree verification, decode (n = 1) and causal
prefill.  It returns the normalised output plus the softmax stats
``(m, l)``, so partial results over different KV sources merge exactly
(``ops.combine_lse``).

Layouts follow the JAX function: ``q [B,H,n,hd]``, ``k/v [B,KV,L,hd]``.
The port's caches are ``[B,L,KV,hd]``; callers pass ``cache.transpose(1,
2)``, a view, and the kernel reads it by stride, so no transposed copy is
made.  Stats come back as ``[B,H,n]`` (the Pallas kernel replicates them
over 128 lanes, a TPU tiling artefact).

int8 mode: ``k_scale``/``v_scale`` ``[B,KV,L]`` fp32 mark ``k``/``v`` as
per-row symmetric int8 (the int8 serving cache, ``quant.quantize_rows``).
The kernel dequantizes each row, ``float(q) * scale``, as it stages the
tile, and the rest is the fp32 arithmetic; the plain version dequantizes
the whole tensors and runs the fp32 plain path.  Scales are passed as
views of the ``[B,L,KV]`` scale caches, like K/V.

What bounds the kernel on an H100: bytes, and at the main path's sizes
(B = 1, a few hundred keys) launch latency and one CTA's serial chain.
The kernel (``csrc/flash_attention_lse.cu``) runs QK^T and PV on the
tensor cores in 3xTF32 and splits the key range into absolute chunks of
``chunk_keys(hd)`` logical positions, and the chunks into absolute groups
of ``group_chunks(hd, int8)`` chunks (4096 keys).  A query tile computes
the chunks ``chunk_plan`` gives it.  Up to one group of chunks in the
cache each chunk has a CTA of its own; past it a grid row holds
``max(G, cta_cap(...))`` CTAs (``grid_x``), a bound set by the card and
not by the cache length, and CTA x computes the tile's slots x,
x + grid.x, ... (``cta_slots``).  Each chunk's (acc, m, l) goes to the scratch; the last
CTA to finish a chunk of a group merges the group's chunks in chunk order
(``merge_chunks``'s arithmetic), and a tile spanning several groups then
merges the groups' partials in group order (``merge_groups`` is both
levels in plain PyTorch).  A tile within one group gives the
single-level merge's bits.  The plan depends on head_dim and on the batch
row's own bounds only, so a row's bits do not depend on B, on other rows
or on which CTA computed a chunk, and the paged mode follows the same
plan.  One launch per call; the wrapper keeps the partials, strided by
the tile's own rows (``scratch_sizes``), and the counters on the card.

Dispatch: a CPU tensor goes to ``flash_attention_lse_plain``; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``launches`` and
``launches_int8`` on the wrapper count kernel launches in the fp32 and the
int8 mode; ``launches_hd256`` and ``launches_int8_hd256`` count those of
them that ran the head_dim 256 instance (Gemma, RecurrentGemma), and
``launches_hd256_window`` / ``launches_int8_hd256_window`` those of these
with a window (RecurrentGemma's local attention).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.counting import bump_attr
from repro_torch.kernels import build

NEG_INF = -1e30
MIN_L = 1e-30
# (query, head) rows per CTA: the kernel takes max(1, ROWS // rep) queries
# of all rep heads of a KV head per CTA
ROWS = 64
# keys per shared-memory tile of the kernel
TILE = 32
# logical keys per group of chunks, and the waves of resident CTAs a
# grid row spreads over its tiles (``kGroupKeys``, ``kWaves`` in the source)
GROUP_KEYS = 4096
WAVES = 2
# the widest head the attention kernels take: instances for head_dim 64,
# 128 and 256 (Gemma), each serving every head_dim up to its own
MAX_HEAD_DIM = 256

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
_ARGTYPES = [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I64,
             _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P,
             _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P]


def chunk_keys(hd: int) -> int:
    """Logical key positions per chunk of the kernel's plan: a function of
    head_dim alone (``chunk_keys`` in ``csrc/flash_attention_lse.cu``)."""
    return 64 if hd > 64 else 128


def queries_per_cta(rep: int) -> int:
    """Queries of all ``rep`` heads of a KV head in one CTA's rows."""
    return max(1, ROWS // rep)


def chunk_plan(hd, length, kv_len, qpos, n, rep, *, causal=False,
               window=0):
    """The kernel's plan, per (batch row, query tile): the chunks
    ``range(c_lo, c_hi)`` whose CTAs compute; the other CTAs of the grid
    exit at once.  ``kv_len`` [B] and ``qpos`` [B, n] (or None) as the
    kernel takes them.  A tile's chunks depend on ``hd``, ``length`` and
    its own batch row's bounds alone.  Returns ``[[(c_lo, c_hi), ...
    per tile] per row]``."""
    c = chunk_keys(hd)
    bq = queries_per_cta(rep)
    plan = []
    for b in range(len(kv_len)):
        tiles = []
        for q0 in range(0, n, bq):
            end = min(length, int(kv_len[b]))
            start = 0
            if qpos is not None and (causal or window > 0):
                qs = [int(x) for x in qpos[b][q0:q0 + bq]]
                if causal:
                    end = min(end, max(qs) + 1)
                if window > 0:
                    start = max(0, min(qs) - window + 1)
            c_lo = start // c if start < end else 0
            tiles.append((c_lo, max(c_lo + 1, -(-end // c))))
        plan.append(tiles)
    return plan


def merge_chunks(parts):
    """Merge chunk partials ``[(acc, m, l), ...]`` in chunk order as the
    kernel's last CTA does: ``acc`` unnormalised [..., hd], ``m``/``l``
    [...].  Returns (o, m, l) with o = sum_c acc_c exp(m_c - M) /
    max(l, 1e-30) and l = sum_c l_c exp(m_c - M)."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, m, lc in parts:
        w = torch.exp(m - mx)
        l = l + lc * w
        acc = acc + a * w[..., None]
    return acc / l.clamp_min(MIN_L)[..., None], mx, l


def group_chunks(hd: int, int8: bool = False) -> int:
    """Chunks per group of the kernel's plan (``group_chunks`` in the
    source): 4096 keys, a function of head_dim alone.  ``int8`` is there
    because a group's merge staging has to fit either dtype's shared
    memory; at 4096 keys it fits both at 64 rows, so both take the same
    G."""
    del int8
    return GROUP_KEYS // chunk_keys(hd)


def cta_cap(tiles: int, per_sm: int, sms: int) -> int:
    """CTAs a grid row may hold: ``WAVES`` waves of the ``per_sm * sms``
    CTAs the card keeps resident, spread over ``tiles`` (batch rows x KV
    heads x query tiles)."""
    return max(1, WAVES * per_sm * sms // tiles)


def grid_x(hd, length, tiles, per_sm, sms) -> int:
    """The kernel's grid.x: one CTA per chunk of ``length`` up to one
    group, at most ``max(G, cta_cap)``."""
    chunks = max(1, -(-length // chunk_keys(hd)))
    return min(chunks, max(group_chunks(hd), cta_cap(tiles, per_sm, sms)))


def cta_slots(plan, gx: int):
    """Which CTA of a grid row of ``gx`` CTAs computes which chunk: for
    each tile of ``plan`` (``chunk_plan``'s ``[[(c_lo, c_hi), ...]
    per row]``), CTA x computes the chunks c_lo + x, c_lo + x + gx, ...
    below c_hi.  Returns ``[[[chunks of CTA x] for x < gx] per tile] per
    row]``."""
    return [[[list(range(c_lo + x, c_hi, gx)) for x in range(gx)]
             for c_lo, c_hi in tiles] for tiles in plan]


def _group_partial(parts):
    """``merge_chunks``'s sums without the division: (acc, M, l)."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, m, lc in parts:
        w = torch.exp(m - mx)
        l = l + lc * w
        acc = acc + a * w[..., None]
    return acc, mx, l


def merge_groups(parts, c_lo: int, g: int):
    """The kernel's two-level merge of chunk partials ``[(acc, m, l),
    ...]`` of the chunks c_lo, c_lo + 1, ...: within one group of ``g``
    chunks, ``merge_chunks``; else each group's chunks in chunk order
    into an unnormalised (acc, M, l), then the groups in group order
    (``merge_chunks`` over the group partials).  Returns (o, m, l)."""
    groups = {}
    for i, part in enumerate(parts):
        groups.setdefault((c_lo + i) // g, []).append(part)
    if len(groups) == 1:
        return merge_chunks(parts)
    return merge_chunks([_group_partial(groups[k]) for k in sorted(groups)])


def scratch_sizes(b, kvh, n, rep, length, hd):
    """(floats, ints) of the kernel's scratch for one call: for every
    (batch row, KV head, query tile), a partial per chunk of ``length``
    and per group, each min(bq, n) * rep rows of (hd + 2) floats rounded
    up to whole 16-byte vectors; a counter per group and one per tile.
    (0, 0) when ``length`` is one chunk (the kernel writes o directly)."""
    bq = queries_per_cta(rep)
    tiles = b * kvh * -(-n // bq)
    chunks = max(1, -(-length // chunk_keys(hd)))
    if chunks == 1:
        return 0, 0
    groups = -(-chunks // group_chunks(hd))
    pstride = -(-(min(bq, n) * rep * (hd + 2)) // 4) * 4
    return tiles * (chunks + groups) * pstride, tiles * (groups + 1)


def scratch_for(device, b, kvh, n, rep, length, hd):
    """The kernel's scratch for one call (``scratch_sizes``): pointers to
    the partials and the counters, or (None, None)."""
    floats, ints = scratch_sizes(b, kvh, n, rep, length, hd)
    if not floats:
        return None, None
    work, count = build.scratch("flash_attention_lse", device, floats, ints)
    return work.data_ptr(), count.data_ptr()


def launch_grid(b, h, kvh, n, length, hd, *, int8=False, paged=False):
    """The grid (x, y, z) a launch of these sizes takes on the current
    card (the kernel library's own rule): x times y times z CTAs."""
    fn = build.launcher("flash_attention_lse", [_I32] * 9 + [_P],
                        symbol="flash_attention_lse_grid")
    out = (ctypes.c_int * 3)()
    build.check("flash_attention_lse_grid",
                fn(int(paged), b, h, kvh, n, length, hd,
                   queries_per_cta(h // kvh), int(int8), out))
    return tuple(out)


def rows_i32(x, b: int, device) -> torch.Tensor:
    """Per-batch-row int32 vector ``[b]`` on ``device`` from an int, a
    sequence or a tensor holding one entry or ``b`` entries."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    t = t.to(device=device, dtype=torch.int32).reshape(-1)
    if t.numel() == 1:
        return t.expand(b).contiguous()
    if t.numel() != b:
        raise ValueError(f"expected 1 or {b} row values, got {t.numel()}")
    return t.contiguous()


def qpos_rows(qpos, b: int, n: int, device) -> Optional[torch.Tensor]:
    """Query positions as int32 ``[b, n]`` from ``[n]`` or ``[b, n]``."""
    if qpos is None:
        return None
    t = qpos if isinstance(qpos, torch.Tensor) else torch.as_tensor(qpos)
    t = t.to(device=device, dtype=torch.int32)
    if t.dim() == 1:
        t = t[None]
    return t.expand(b, n).contiguous()


def valid_mask(b, n, length, kv_len, qpos, causal, window, device):
    """[B, n, L] bool: which keys each query may attend."""
    kpos = torch.arange(length, device=device)
    valid = (kpos[None, :] < kv_len[:, None].long())[:, None, :]
    valid = valid.expand(b, n, length)
    if causal or window > 0:
        qp = (qpos if qpos is not None
              else torch.zeros(b, n, dtype=torch.int32, device=device))
        qp = qp.long()[..., None]
        if causal:
            valid = valid & (kpos <= qp)
        if window > 0:
            valid = valid & (kpos > qp - window)
    return valid


def masked_softmax_lse(qs, k, v, valid):
    """The kernels' arithmetic on whole tensors: qs [B,KV,rep,n,hd] already
    scaled, k/v [B,KV,L,hd], valid broadcastable to [B,KV,rep,n,L].
    Masked scores are -1e30 and their probabilities zero; l is floored at
    1e-30 in the division only.  Returns o, m, l shaped like qs[..., :]."""
    s = torch.einsum("bgrnd,bgld->bgrnl", qs, k.float())
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros((), device=s.device))
    l = p.sum(-1)
    o = torch.einsum("bgrnl,bgld->bgrnd", p, v.float())
    return o / l.clamp_min(MIN_L)[..., None], m, l


def dequant_kv(k, v, k_scale, v_scale):
    """fp32 K/V: int8 rows times their scales when ``k_scale`` is given
    (the kernels' staging arithmetic), else ``k``/``v`` as they are."""
    if k_scale is None:
        return k, v
    return k.float() * k_scale[..., None], v.float() * v_scale[..., None]


def check_kv(name, k, v, k_scale, v_scale):
    """Raise unless K/V are fp32 without scales, or int8 with fp32 scales
    of their leading shape; k/v share strides, and so do the scales.
    Returns whether the int8 mode is asked for."""
    int8 = k_scale is not None
    if (v_scale is None) == int8:
        raise ValueError(f"{name}: give both k_scale and v_scale or neither")
    want = torch.int8 if int8 else torch.float32
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{name} kernel takes {want} k/v "
                        f"{'with' if int8 else 'without'} scales, got "
                        f"{k.dtype}/{v.dtype}")
    if k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError(f"{name}: k/v need a contiguous head dim and one "
                         "shared set of strides")
    if int8 and (k_scale.dtype != torch.float32
                 or v_scale.dtype != torch.float32
                 or k_scale.shape != k.shape[:3]
                 or v_scale.shape != k.shape[:3]
                 or k_scale.stride() != v_scale.stride()):
        raise ValueError(f"{name}: scales must be fp32 {tuple(k.shape[:3])} "
                         "with one shared set of strides")
    return int8


def scale_args(k_scale, v_scale):
    """The scale pointers and their strides as the launch ABI takes them
    (null pointers and zero strides for fp32)."""
    if k_scale is None:
        return [None, None, 0, 0, 0]
    return [k_scale.data_ptr(), v_scale.data_ptr(), *k_scale.stride()]


def flash_attention_lse_plain(q, k, v, kv_len, qpos=None, *, scale: float,
                              window: int = 0, causal: bool = False,
                              k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel (same masking semantics).
    ``kv_len`` int32 [B], ``qpos`` int32 [B,n] or None; int8 K/V with
    their scales are dequantized first."""
    k, v = dequant_kv(k, v, k_scale, v_scale)
    b, h, n, hd = q.shape
    kvh, length = k.shape[1], k.shape[2]
    rep = h // kvh
    qs = (q.float() * scale).reshape(b, kvh, rep, n, hd)
    valid = valid_mask(b, n, length, kv_len, qpos, causal, window, q.device)
    o, m, l = masked_softmax_lse(qs, k, v, valid[:, None, None])
    return o.reshape(b, h, n, hd), m.reshape(b, h, n), l.reshape(b, h, n)


def _launch(q, k, v, kv_len, qpos, *, scale, window, causal, k_scale,
            v_scale):
    b, h, n, hd = q.shape
    kvh, length = k.shape[1], k.shape[2]
    int8 = check_kv("flash_attention_lse", k, v, k_scale, v_scale)
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise TypeError("flash_attention_lse kernel takes fp32 q with a "
                        "contiguous head dim")
    if h % kvh or hd > MAX_HEAD_DIM or h // kvh > ROWS:
        raise ValueError(f"unsupported shape H={h} KV={kvh} hd={hd}")
    if (causal or window > 0) and qpos is None:
        raise ValueError("causal or window masking needs qpos")
    rep = h // kvh
    o = torch.empty((b, h, n, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.launcher("flash_attention_lse", _ARGTYPES)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
             k.stride(2), *scale_args(k_scale, v_scale),
             kv_len.data_ptr(),
             None if qpos is None else qpos.data_ptr(),
             o.data_ptr(), m.data_ptr(), l.data_ptr(),
             *scratch_for(q.device, b, kvh, n, rep, length, hd),
             b, h, kvh, n, length, hd, queries_per_cta(rep), int(causal),
             int(window), float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention_lse", err)
    mode = "launches_int8" if int8 else "launches"
    bump_attr(flash_attention_lse, mode)
    if hd > 128:     # the head_dim 256 instance (Gemma, RecurrentGemma)
        bump_attr(flash_attention_lse, mode + "_hd256")
        if window > 0:   # RecurrentGemma's local attention
            bump_attr(flash_attention_lse, mode + "_hd256_window")
    return o, m, l


def flash_attention_lse(q, k, v, kv_len, qpos=None, *, k_scale=None,
                        v_scale=None, scale: Optional[float] = None,
                        window: int = 0, causal: bool = False):
    """q [B,H,n,hd]; k/v [B,KV,L,hd] (views are read by stride); kv_len an
    int or per-row [B] valid prefix; qpos [n] or [B,n] absolute query
    positions (needed for ``causal`` and ``window``); k_scale/v_scale
    [B,KV,L] fp32 for int8 k/v.

    Returns (o [B,H,n,hd], m [B,H,n], l [B,H,n]), all fp32.
    """
    b, h, n, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv = rows_i32(kv_len, b, q.device)
    qp = qpos_rows(qpos, b, n, q.device)
    # device dispatch is in two layers: the CPU here, meta tensors one
    # layer up in ``ops._flash`` (the dry run); this wrapper refuses meta
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, kv, qp, scale=scale,
                                         window=window, causal=causal,
                                         k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention_lse for {q.device}")
    return _launch(q, k, v, kv, qp, scale=scale, window=window,
                   causal=causal, k_scale=k_scale, v_scale=v_scale)


flash_attention_lse.launches = 0
flash_attention_lse.launches_int8 = 0
flash_attention_lse.launches_hd256 = 0
flash_attention_lse.launches_int8_hd256 = 0
flash_attention_lse.launches_hd256_window = 0
flash_attention_lse.launches_int8_hd256_window = 0
