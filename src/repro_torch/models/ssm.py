"""Mamba-2 (SSD, state-space duality) block, arXiv:2405.21060: the port of
the JAX package's ``repro/models/ssm.py``.

Block layout (ngroups = 1):
    in_proj  -> z (d_inner), xBC (d_inner + 2 d_state), dt (n_heads)
    conv1d (width d_conv, depthwise) + silu over xBC
    SSD recurrence per head h (scalar A_h):
        S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t (x) B_t,   y_t = S_t C_t + D_h x_t
    y * silu(z) -> RMSNorm -> out_proj

The whole-sequence form is the reference's chunked SSD algorithm in fp32,
at the config's chunk size: within a chunk a masked [Q, Q] product under
the decay matrix exp(cum_i - cum_j), j <= i; across chunks a short loop
carries the state.  It computes in plain PyTorch, as the reference
computes in ``jnp`` (no Pallas kernel runs here).

Decode keeps ``{"conv" [B, d_conv-1, ch], "ssd" [B, H, hd, N]}``: the last
``d_conv - 1`` *pre-conv* inputs and the SSD state.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (RMSNorm, dense_init_, param, rmsnorm,
                                       wide)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    return s, di, nh, s.head_dim, s.d_state


class SSM(nn.Module):
    """The SSD mixer's weights in the JAX layouts: ``in_proj [d, 2 di + 2N
    + H]``, ``conv_w [d_conv, ch]``, ``conv_b [ch]``, ``dt_bias``,
    ``A_log``, ``D`` [H] and ``norm`` over di, ``out_proj [di, d]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        s, di, nh, _, n = _dims(cfg)
        ch = di + 2 * n
        self.in_proj = param((cfg.d_model, 2 * di + 2 * n + nh), device)
        self.conv_w = param((s.d_conv, ch), device)
        self.conv_b = param((ch,), device)
        self.dt_bias = param((nh,), device)
        self.A_log = param((nh,), device)
        self.D = param((nh,), device)
        self.norm = RMSNorm(di, cfg.norm_eps, device)
        self.out_proj = param((di, cfg.d_model), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions: LeCun normal projections and
        conv, zero conv bias and dt bias, A = -1, D = 1, unit norm."""
        for w in (self.in_proj, self.conv_w, self.out_proj):
            dense_init_(w, w.shape[0], gen)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.norm.reset_parameters()


def _split_proj(cfg: ModelConfig, proj):
    _, di, _, _, n = _dims(cfg)
    return (proj[..., :di], proj[..., di:di + di + 2 * n],
            proj[..., di + di + 2 * n:])


def _conv_full(p: SSM, xbc):
    """Depthwise causal conv over [B,S,ch] (zero left pad), then silu."""
    k = p.conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:xbc.shape[1]] * p.conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + xbc.shape[1]] * p.conv_w[i]
    return F.silu(out + p.conv_b)


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, initial_state=None):
    """Chunked SSD scan (the reference's algorithm, in fp32, or float64
    for float64 inputs).

    x [b,T,H,hd] (conv'd, activated), dt [b,T,H] (softplus'd), A [H]
    (negative), B/C [b,T,N], D [H]; T a multiple of ``chunk``.  Returns
    (y [b,T,H,hd], final_state [b,H,hd,N] fp32 or float64)."""
    b, t, h, hd = x.shape
    n = B.shape[-1]
    q = chunk
    if t % q:
        raise ValueError(f"T={t} is not a multiple of the chunk {q}")
    nc = t // q
    xr = wide(x.reshape(b, nc, q, h, hd))
    dtr = wide(dt.reshape(b, nc, q, h))
    Br = wide(B.reshape(b, nc, q, n))
    Cr = wide(C.reshape(b, nc, q, n))

    cum = torch.cumsum(dtr * A, dim=2)                  # inclusive
    # in-chunk decay L[i, j] = exp(cum_i - cum_j), j <= i.  Above the
    # diagonal li is positive and grows with the chunk's sum of dt |A|;
    # masking it to -inf before exp gives the same 0 there, where
    # selecting 0 after exp would backpropagate 0 * inf = nan once
    # exp overflows (li > 88.7 in fp32)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,q,q,h]
    ar = torch.arange(q, device=x.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    L = torch.exp(li.masked_fill(~mask, -torch.inf))

    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    w = cb[..., None] * L
    y_intra = torch.einsum("bcijh,bcjh,bcjhd->bcihd", w, dtr, xr)

    total = cum[:, :, -1, :]                            # [b,nc,h]
    decay_out = torch.exp(total[:, :, None, :] - cum)   # j -> chunk end
    s_in = torch.einsum("bcjh,bcjh,bcjhd,bcjn->bchdn", decay_out, dtr, xr,
                        Br)

    state = (torch.zeros((b, h, hd, n), dtype=xr.dtype, device=x.device)
             if initial_state is None else wide(initial_state))
    prev = []
    for c in range(nc):       # the state entering each chunk
        prev.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_in[:, c]
    prev_states = torch.stack(prev, dim=1)              # [b,nc,h,hd,n]

    y_inter = torch.einsum("bcin,bcih,bchdn->bcihd", Cr, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(b, t, h, hd)
    y = y + wide(x) * D[None, None, :, None]
    return y.to(x.dtype), state


def ssm_forward(p: SSM, cfg: ModelConfig, x_in, *, initial_state=None
                ) -> Tuple[torch.Tensor, dict]:
    """Whole-sequence SSD block: x_in [B,S,d] -> (y [B,S,d], state
    {"conv", "ssd"} ready for ``ssm_decode``).  T is padded to a multiple
    of min(chunk, S) (padded steps have dt 0: no decay, no input)."""
    s, di, nh, hd, n = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, x_in @ p.in_proj)
    pre_conv = xbc
    xbc = _conv_full(p, xbc)
    xi, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(wide(dt) + p.dt_bias)
    A = -torch.exp(p.A_log)
    b, t, _ = x_in.shape
    q = min(s.chunk, t)
    pad = (-t) % q
    if pad:
        xi, B, C, dt = (F.pad(u, (0, 0, 0, pad)) for u in (xi, B, C, dt))
    y, state = ssd_chunked(xi.reshape(b, t + pad, nh, hd), dt, A, B, C, p.D,
                           chunk=q, initial_state=initial_state)
    y = y[:, :t].reshape(b, t, di) * F.silu(z)
    y = rmsnorm(p.norm.scale, y, cfg.norm_eps)
    k = s.d_conv - 1
    conv_state = (pre_conv[:, t - k:] if t >= k
                  else F.pad(pre_conv, (0, 0, k - t, 0)))
    dtype = initial_state.dtype if initial_state is not None else x_in.dtype
    return y @ p.out_proj, {"conv": conv_state, "ssd": state.to(dtype)}


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> dict:
    """Zeroed decode state {"conv" [B, d_conv-1, ch], "ssd" [B,H,hd,N]}."""
    s, di, nh, hd, n = _dims(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, di + 2 * n),
                                device=device),
            "ssd": torch.zeros((batch, nh, hd, n), device=device)}


def ssm_decode(p: SSM, cfg: ModelConfig, x_in, state: dict):
    """One-token step: x_in [B,1,d] -> (y [B,1,d], new state) (new
    tensors; the caller writes them where it keeps the state)."""
    _, di, nh, hd, n = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, x_in[:, 0] @ p.in_proj)
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b)
    xi = xbc[..., :di].reshape(-1, nh, hd)
    B, C = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias)             # [B,H]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)
    inject = torch.einsum("bh,bhd,bn->bhdn", dt, xi.float(), B.float())
    new_ssd = state["ssd"].float() * decay[:, :, None, None] + inject
    y = (torch.einsum("bhdn,bn->bhd", new_ssd, C.float())
         + xi.float() * p.D[None, :, None])
    y = y.reshape(-1, di).to(x_in.dtype) * F.silu(z)
    y = rmsnorm(p.norm.scale, y, cfg.norm_eps) @ p.out_proj
    return y[:, None, :], {"conv": window[:, 1:],
                           "ssd": new_ssd.to(state["ssd"].dtype)}
