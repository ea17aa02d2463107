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
``[N]`` once, after the whole sum (the reference's association).  The
kernel (``csrc/dequant_matmul.cu``) runs the products on the tensor cores:
an int8 weight is exact in bf16, and x is split exactly into ``PASSES``
bf16 terms (``split_bf16``), each multiplied by the same weights with fp32
accumulation.  What bounds it on an H100: the int8 weight bytes at the
main path's M (1 to 8 rows), the tensor cores at a prefill's M = 128.
The K range of a column tile is split across CTAs by ``k_split``, which
depends on K and N only, and an output element's sum never depends on M or
on the row's place in the tile, so a row gives the same bits at M = 1
(decode), M = 8 (tree verify) and M = 128 (prefill).  One launch per call:
the last CTA of a column tile sums the splits' partials in split order; the
wrapper keeps the partials buffer and the per-tile counters on the card.

Dispatch: a CPU tensor goes to ``dequant_matmul_plain``; a CUDA tensor
goes to the kernel, or the wrapper raises.  ``launches`` on the wrapper
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.counting import bump_attr
from repro_torch.kernels import build

Q_MAX = 127.0

# kernel tiling (csrc/dequant_matmul.cu): output columns per CTA, K rows
# per ring stage, rows of x per CTA; the K plan: a split takes at most
# ROWS_PER_SPLIT K rows where K allows, and narrow shapes split further, up
# to SLOTS CTAs (about five per SM of an H100), never below
# MIN_K_PER_SPLIT rows or above MAX_SPLITS splits
BLOCK_N = 128
BLOCK_K = 64
BLOCK_M = 128
SLOTS = 660
ROWS_PER_SPLIT = 1024
MIN_K_PER_SPLIT = 128
MAX_SPLITS = 32
# bf16 terms of x in the kernel's products (3 carry fp32's 24 bits)
PASSES = 3

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]

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
    column tile, and how many K rows each takes, each split a whole number
    of BLOCK_K steps.  It depends on K and N only, so an output element's
    sum order never depends on M.  A long K range is cut into splits of
    about ROWS_PER_SPLIT rows; a shape with few column tiles splits further
    so that its CTAs approach SLOTS (at least MIN_K_PER_SPLIT rows, at most
    MAX_SPLITS splits)."""
    tiles = -(-n // BLOCK_N)
    fill = min(k // MIN_K_PER_SPLIT, SLOTS // tiles)
    want = max(1, min(MAX_SPLITS, max(k // ROWS_PER_SPLIT, fill)))
    chunk = -(-k // want)
    chunk = -(-chunk // BLOCK_K) * BLOCK_K
    return -(-k // chunk), chunk


def split_bf16(x: torch.Tensor, passes: int = PASSES):
    """The kernel's split of fp32 ``x`` into ``passes`` bf16 terms: each
    term is the top 16 bits of what is left (truncation, so no term
    overflows), and each remainder is exact in fp32.  Three terms sum back
    to ``x`` exactly, except where the last falls below bf16's subnormal
    range."""
    terms, r = [], x.float()
    for _ in range(passes):
        hi = (r.view(torch.int32) & -65536).view(torch.float32)
        terms.append(hi.to(torch.bfloat16))
        r = r - hi
    return terms


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
    work, counters = build.scratch(
        "dequant_matmul", x.device, splits * m * n if splits > 1 else 0,
        -(-m // BLOCK_M) * -(-n // BLOCK_N))
    fn = build.launcher("dequant_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
             out.data_ptr(), work.data_ptr(), counters.data_ptr(),
             m, k, n, splits, chunk,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("dequant_matmul", err)
    bump_attr(dequant_matmul, "launches")
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

