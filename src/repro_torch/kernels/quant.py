"""Symmetric int8 quantization and the dequant-matmul: CUDA kernel + plain
twin.

Replaces the host functions and the Pallas kernel of the JAX package's
``repro/kernels/quant.py`` (``dequant_matmul_kernel``).  Two
granularities serve the int8 serving path, with the reference's
arithmetic:

  * **KV rows** (``quantize_rows``): one fp32 scale per cache row, that is
    per (batch, position, kv-head) slice, reducing over ``head_dim``.  The
    attention kernels take the scales beside the int8 K/V and dequantize
    each row as it is staged (``flash``, ``tree_block``).
  * **weights** (``quantize_weight``): one fp32 scale per output channel
    (the trailing axes of the projection), reducing over the leading
    ``n_in`` contraction axes.

Symmetric scheme: ``scale = amax / 127`` (1 for an all-zero slice, so the
round trip gives exact zeros), ``q = clip(round(x / scale), -127, 127)``
with round-half-to-even as in ``jnp.round``, ``dequant = q * scale``.  The
division is a true division, as in the reference, so the port quantizes
the same fp32 numbers to the same int8 values bit for bit.

``dequant_matmul(x, w_q, w_scale)`` computes ``x [M,K] f32 @ int8 w_q
[K,N]`` accumulated in fp32 and multiplies by the per-out-channel scale
``[N]`` once, after the whole sum (the reference's association).  What
bounds it on an H100: the int8 weight bytes at the main path's M (1 to 8
rows); see ``csrc/dequant_matmul.cu``.  The sum over K of an output
element is taken in an order that depends on K and N only, never on M or
on the row's place in the tile, so a row gives the same bits at M = 1
(decode) and at M = 8 (tree verify).

Dispatch: a CPU tensor goes to ``dequant_matmul_plain``; a CUDA tensor
goes to the kernel, or the wrapper raises.  ``launches`` on the wrapper
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Q_MAX = 127.0

# kernel tiling (csrc/dequant_matmul.cu): output columns per CTA, K rows
# staged per step, and the CTA count the K split aims for (two per SM)
BLOCK_N = 128
BLOCK_K = 256
TARGET_CTAS = 264
MIN_K_PER_SPLIT = 512

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]


def _div_q_max(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as a true division.  PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can differ in the last bit;
    a divisor tensor on the same device is divided exactly, on the card
    and on the CPU alike."""
    return amax / torch.full_like(amax, Q_MAX)


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 with one scale per slice along ``axis``.  Returns
    ``(q int8, scale f32)``: ``q`` keeps ``x``'s shape, ``scale`` drops
    ``axis``.  All-zero slices give zeros with scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, _div_q_max(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s), -Q_MAX, Q_MAX)
    return q.to(torch.int8), s.squeeze(axis)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, axis: int = -1):
    """Inverse of ``quantize_rows``: ``scale`` broadcast back over
    ``axis`` (fp32 result)."""
    return q.float() * scale.unsqueeze(axis)


def quantize_weight(w: torch.Tensor, n_in: int):
    """Per-out-channel symmetric int8: the first ``n_in`` axes of ``w``
    contract (reduced for the amax), the rest are output channels.
    Returns ``(q8 int8 [*w.shape], scale f32 [*w.shape[n_in:]])``."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(n_in)))
    s = torch.where(amax > 0, _div_q_max(amax), torch.ones_like(amax))
    q = wf / s                  # one fp32 temporary: a full-width weight
    q.round_().clamp_(-Q_MAX, Q_MAX)   # is up to 0.9 GB
    return q.to(torch.int8), s


def is_quantized(w) -> bool:
    """True for a quantized weight: anything holding ``q8`` and ``scale``
    (the models' ``QuantWeight``, or the JAX package's ``{"q8", "scale"}``
    dict)."""
    return (isinstance(w, dict) and "q8" in w) or hasattr(w, "q8")


def dequantize_weight(q8: torch.Tensor, scale: torch.Tensor):
    """fp32 weight from int8 values and per-out-channel scales (the scale
    broadcasts over the trailing output-channel axes)."""
    return q8.float() * scale


def dequant_matmul_plain(x, w_q, w_scale):
    """Plain PyTorch version: ``(x @ float(w_q)) * w_scale``, the scale
    applied after the fp32 sum."""
    return (x.float() @ w_q.float()) * w_scale


def k_split(k: int, n: int):
    """(splits, rows per split): how many CTAs share the K range of one
    column tile, and how many K rows each takes.  It depends on K and N
    only, so an output element's sum order never depends on M.  It aims
    for TARGET_CTAS CTAs over the N tiles, with at least MIN_K_PER_SPLIT
    rows per split, each split a whole number of BLOCK_K steps."""
    tiles = -(-n // BLOCK_N)
    want = max(1, min(-(-TARGET_CTAS // tiles), k // MIN_K_PER_SPLIT))
    chunk = -(-k // want)
    chunk = -(-chunk // BLOCK_K) * BLOCK_K
    return -(-k // chunk), chunk


def _launch(x, w_q, w_scale):
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype != torch.float32 or w_q.dtype != torch.int8 or \
            w_scale.dtype != torch.float32:
        raise TypeError("dequant_matmul kernel takes fp32 x, int8 w_q and "
                        "fp32 w_scale")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and w_scale.is_contiguous()):
        raise ValueError("dequant_matmul kernel takes contiguous x, w_q, "
                         "w_scale")
    if w_q.shape[0] != k or w_scale.shape != (n,):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} do not chain")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits, chunk = k_split(k, n)
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn = build.launcher("dequant_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
             out.data_ptr(), None if work is None else work.data_ptr(),
             m, k, n, splits, chunk,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("dequant_matmul", err)
    dequant_matmul.launches += 1
    return out


def dequant_matmul(x, w_q, w_scale):
    """x [M,K] f32 @ int8 w_q [K,N] with per-out-channel f32 scales [N] ->
    [M,N] f32."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"no dequant_matmul for {x.device}")
    if x.shape[0] == 0:
        return x.new_zeros((0, w_q.shape[1]))
    return _launch(x.contiguous(), w_q, w_scale)


dequant_matmul.launches = 0

