"""Shared building blocks: RMSNorm, RoPE, the MLPs (SwiGLU, GeGLU, GELU),
embeddings.

Weights keep the JAX package's shapes and layouts (``w_gate [d, ff]``,
``table [V, d]``), so the weight bridge copies arrays as they are.  The
port's own initialisers draw from the same distributions as the JAX
package's (``repro/models/layers.py``), from a ``torch.Generator``; they do
not draw the same values.

A projection of an int8 model is a ``QuantWeight``: int8 values in the
fp32 weight's layout and one fp32 scale per output channel (the JAX
package's ``{"q8", "scale"}`` dict).  ``matmul`` applies either kind.

Weights take no gradient until ``trainable`` switches an fp32 model's
parameters on for training; an int8 model refuses.  The fp32 functions
here compute in fp32, or in float64 for a ``model.double()`` copy (the
training check's reference), never narrower than their input.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.kernels import ops


def param(shape, device) -> nn.Parameter:
    """An uninitialised fp32 weight that takes no gradient (until
    ``trainable``)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


def trainable(module: nn.Module) -> list:
    """Switch every weight of ``module`` to take a gradient and return
    them, in ``parameters()`` order.  An int8 module (``QuantWeight``s)
    has no trainable form and raises."""
    if any(isinstance(m, QuantWeight) for m in module.modules()):
        raise ValueError("an int8 (QuantWeight) model cannot be trained: "
                         "train the fp32 model and quantize it afterwards")
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(True)
    return params


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is float64."""
    return x if x.dtype == torch.float64 else x.float()


class QuantWeight(nn.Module):
    """An int8 projection weight: ``q8`` int8 ``[*shape]`` in the fp32
    weight's layout and ``scale`` fp32 ``[*shape[n_in:]]``, one per output
    channel; the first ``n_in`` axes contract (``quant.quantize_weight``
    makes both)."""

    def __init__(self, shape, n_in: int, device):
        super().__init__()
        self.register_buffer("q8", torch.empty(shape, dtype=torch.int8,
                                               device=device))
        self.register_buffer("scale", torch.empty(
            shape[n_in:], dtype=torch.float32, device=device))


def weight(shape, n_in: int, quant: bool, device):
    """A projection weight: an fp32 ``param``, or a ``QuantWeight`` whose
    first ``n_in`` axes contract when ``quant``."""
    return QuantWeight(shape, n_in, device) if quant else param(shape, device)


def matmul(x, w):
    """``x @ w`` for an fp32 weight, or through the ``dequant_matmul``
    kernel for a ``QuantWeight``."""
    if isinstance(w, QuantWeight):
        return ops.quant_matmul(x, w.q8, w.scale)
    return x @ w


def dense_init_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """LeCun normal over the input dimension, in place."""
    w.normal_(generator=gen).mul_(1.0 / math.sqrt(max(fan_in, 1)))


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Normal with standard deviation 0.02, in place."""
    w.normal_(generator=gen).mul_(0.02)


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned per-channel scale."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = param((dim,), device)

    def reset_parameters(self) -> None:
        """Scale of ones."""
        self.scale.fill_(1.0)

    def forward(self, x):
        """Normalise the last axis of ``x``."""
        return rmsnorm(self.scale, x, self.eps)


def rmsnorm(scale, x, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * scale, in fp32 (float64 for a float64
    ``x``)."""
    xf = wide(x)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Rotary frequencies of the first half of the head dim, fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float):
    """x [..., S, heads, hd]; positions broadcastable to [..., S].  Rotates
    by half-split (first half against second half), not interleaved."""
    hd = x.shape[-1]
    xf = wide(x)
    freqs = rope_frequencies(hd, theta, x.device).to(xf.dtype)
    angles = positions[..., None].to(xf.dtype) * freqs     # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """Feed-forward block of ``variant``: SwiGLU, silu(x W_gate) * (x W_up)
    W_down; GeGLU, the same with tanh GELU; or plain GELU, gelu(x W_up)
    W_down, with no ``w_gate``.  Int8 ``QuantWeight``s when ``quant``."""

    def __init__(self, d_model: int, d_ff: int, device, quant: bool = False,
                 variant: str = "swiglu"):
        super().__init__()
        if variant not in MLP_VARIANTS:
            raise ValueError(f"unknown mlp variant {variant!r}")
        self.variant = variant
        if variant != "gelu":
            self.w_gate = weight((d_model, d_ff), 1, quant, device)
        self.w_up = weight((d_model, d_ff), 1, quant, device)
        self.w_down = weight((d_ff, d_model), 1, quant, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """LeCun normal weights."""
        for w in ((self.w_up, self.w_down) if self.variant == "gelu"
                  else (self.w_gate, self.w_up, self.w_down)):
            dense_init_(w, w.shape[0], gen)

    def forward(self, x):
        """Apply the block to the last axis of ``x``."""
        return mlp(self, x)


MLP_VARIANTS = ("swiglu", "geglu", "gelu")


def gelu(x):
    """GELU in its tanh form (the JAX package's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, x):
    """The MLP of ``p``'s variant with its weights (fp32 or int8)."""
    if p.variant == "gelu":
        return matmul(gelu(matmul(x, p.w_up)), p.w_down)
    act = F.silu if p.variant == "swiglu" else gelu
    return matmul(act(matmul(x, p.w_gate)) * matmul(x, p.w_up), p.w_down)


def embed(table, tokens):
    """Rows of ``table [V, d]`` for integer ``tokens``."""
    return table[tokens]


def unembed(table, x):
    """Logits ``x @ table.T``."""
    return x @ table.T
