"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port of the JAX package's ``repro/models/rglru.py``.

Block = in-projections to two branches (x, y), a short depthwise conv and
the RG-LRU on the x branch, tanh GELU on the y branch, their product, an
out-projection.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_i x_t)
    a_t = a^(c r_t)          with  a = sigmoid(lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The whole-sequence scan is a log-depth doubling scan of (log a, u) pairs
combined as the reference's ``lax.associative_scan`` combines them:
(la, xa) then (lb, xb) gives (la + lb, exp(lb) xa + xb).  Every factor is
exp of a sum of log-decays (all <= 0), so nothing overflows however long
the prompt.  It computes in plain PyTorch, as the reference computes in
``jnp`` (no Pallas kernel runs here).

Decode keeps ``{"conv" [B, d_conv-1, w], "h" [B, w]}``.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, gelu, param, wide

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """The RG-LRU mixer's weights in the JAX layouts: ``in_x``/``in_y``
    [d, w], ``conv_w [d_conv, w]``, ``conv_b [w]``, ``w_a``/``w_i`` [w, w],
    ``lambda [w]`` and ``out [w, d]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, w = cfg.d_model, _width(cfg)
        self.in_x = param((d, w), device)
        self.in_y = param((d, w), device)
        self.conv_w = param((cfg.rglru.d_conv, w), device)
        self.conv_b = param((w,), device)
        self.w_a = param((w, w), device)
        self.w_i = param((w, w), device)
        self.register_parameter("lambda", param((w,), device))
        self.out = param((w, d), device)

    @property
    def lam(self) -> torch.Tensor:
        """The ``lambda`` parameter (a Python keyword as an attribute)."""
        return getattr(self, "lambda")

    def reset_parameters(self, gen: torch.Generator) -> None:
        """LeCun normal projections and conv, zero conv bias, and lambda
        with sigmoid(lambda)^c uniform on [0.9, 0.999] (Griffin's init)."""
        for w in (self.in_x, self.in_y, self.conv_w, self.w_a, self.w_i,
                  self.out):
            dense_init_(w, w.shape[0], gen)
        self.conv_b.zero_()
        u = torch.empty_like(self.lam).uniform_(0.9, 0.999, generator=gen)
        self.lam.copy_(-torch.log(u ** (-1.0 / _C) - 1.0))


def _gates(p: RGLRU, x):
    """x [..., w] -> (log_a, gated input), both fp32 (float64 for a
    float64 model)."""
    xf = wide(x)
    r = torch.sigmoid(xf @ wide(p.w_a))
    i = torch.sigmoid(xf @ wide(p.w_i))
    log_a = -_C * r * F.softplus(-p.lam)        # log sigmoid(lambda)^(c r)
    a2 = torch.exp(2.0 * log_a)
    return log_a, torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * xf)


def _conv(p: RGLRU, pad, s: int):
    """Depthwise conv of ``pad`` [B, s + d_conv - 1, w] plus bias."""
    out = pad[:, 0:s] * p.conv_w[0]
    for i in range(1, p.conv_w.shape[0]):
        out = out + pad[:, i:i + s] * p.conv_w[i]
    return out + p.conv_b


def rglru_scan(log_a, u, h0=None):
    """h_t = exp(log_a_t) h_{t-1} + u_t over axis 1 (h_{-1} = ``h0``, or
    0), by log-depth doubling: after the step of span d, position t holds
    the combination of inputs (t - 2d, t]."""
    if h0 is not None:
        u = torch.cat([u[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None],
                       u[:, 1:]], dim=1)
    la, h = log_a, u
    t, span = u.shape[1], 1
    while span < t:
        # combine(left = position t - span, right = position t); positions
        # before 0 are the identity (0, 0)
        h = torch.cat([h[:, :span], torch.exp(la[:, span:]) * h[:, :-span]
                       + h[:, span:]], dim=1)
        la = torch.cat([la[:, :span], la[:, :-span] + la[:, span:]], dim=1)
        span *= 2
    return h


def rglru_forward(p: RGLRU, cfg: ModelConfig, x_in, *, state=None):
    """x_in [B,S,d] -> (out [B,S,d], new state {"conv", "h"}); ``state``
    continues a sequence, else the recurrence starts from zero."""
    s = x_in.shape[1]
    xb = x_in @ p.in_x
    yb = gelu(x_in @ p.in_y)
    k = p.conv_w.shape[0]
    if state is not None:
        pad = torch.cat([state["conv"], xb], dim=1)
        new_conv = pad[:, pad.shape[1] - (k - 1):]
    else:
        pad = F.pad(xb, (0, 0, k - 1, 0))
        new_conv = (xb[:, s - (k - 1):] if s >= k - 1
                    else F.pad(xb, (0, 0, k - 1 - s, 0)))
    log_a, gated = _gates(p, _conv(p, pad, s))
    h = rglru_scan(log_a, gated, None if state is None else state["h"])
    out = (h.to(x_in.dtype) * yb) @ p.out
    return out, {"conv": new_conv, "h": h[:, -1]}


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    """Zeroed decode state {"conv" [B, d_conv-1, w], "h" [B, w]}."""
    w, k = _width(cfg), cfg.rglru.d_conv
    return {"conv": torch.zeros((batch, k - 1, w), device=device),
            "h": torch.zeros((batch, w), device=device)}


def rglru_decode(p: RGLRU, cfg: ModelConfig, x_in, state: dict):
    """One-token step: x_in [B,1,d] -> (y [B,1,d], new state) (new
    tensors; the caller writes them where it keeps the state)."""
    xb = x_in[:, 0] @ p.in_x
    yb = gelu(x_in[:, 0] @ p.in_y)
    window = torch.cat([state["conv"], xb[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    log_a, gated = _gates(p, conv)
    h = torch.exp(log_a) * state["h"] + gated
    out = (h.to(x_in.dtype) * yb) @ p.out
    return out[:, None], {"conv": window[:, 1:], "h": h}
