"""Mixture of experts: token-choice top-k routing and sort-based dispatch
into per-expert buffers (the port of the JAX package's
``repro/models/moe.py``, one dispatch group).

Tokens are replicated k times, sorted by expert id (a stable sort), and
packed into an ``[E, C, d]`` buffer of capacity ``C = capacity(T)`` per
expert; copies past an expert's capacity are dropped (Switch/GShard).  The
experts then run as three grouped products over the buffer (``torch.bmm``
through ``einsum``: plain products, which the reference leaves to XLA
outside Pallas), and the k copies of each token are gathered back in the
original order and summed.  Shared experts (Qwen-MoE, DeepSeek, Moonlight)
are a SwiGLU MLP of ``num_shared * d_ff_expert`` width on every token.

Top-k is a stable descending sort, so among router probabilities that tie
the lower expert id comes first, as ``jax.lax.top_k`` orders them.  The
router's load-balance term (``aux``) is returned beside the output.

The reference's mesh knobs (``set_dispatch``: shard-local group sorts and
the sharding constraints of its buffers) have no counterpart on one card;
``launch.sharding`` only describes how the expert weights would be cut
over the reference's production mesh.  Expert counts are a fixed-size
``index_add_`` (``expert_counts``), so a model on the meta device (the
dry run's) routes too.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, dense_init_, mlp, param, wide


class MoE(nn.Module):
    """Router [d,E] (fp32), expert weights w_gate/w_up [E,d,f] and w_down
    [E,f,d], and ``shared`` (a SwiGLU MLP) when the model has shared
    experts."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        mo = cfg.moe
        d, f, e = cfg.d_model, mo.d_ff_expert, mo.num_experts
        self.router = param((d, e), device)
        self.w_gate = param((e, d, f), device)
        self.w_up = param((e, d, f), device)
        self.w_down = param((e, f, d), device)
        self.shared = (MLP(d, mo.num_shared_experts * f, device)
                       if mo.num_shared_experts else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """LeCun normal weights over each expert's input axis."""
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        dense_init_(self.router, d, gen)
        dense_init_(self.w_gate, d, gen)
        dense_init_(self.w_up, d, gen)
        dense_init_(self.w_down, f, gen)
        if self.shared is not None:
            self.shared.reset_parameters(gen)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert buffer for ``tokens`` routed together: ceil(T k / E
    * capacity_factor), rounded up to a multiple of 8 and at least 8."""
    mo = cfg.moe
    c = math.ceil(tokens * mo.experts_per_token / mo.num_experts
                  * mo.capacity_factor)
    return max(8, -(-c // 8) * 8)


def expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """[e] int64: how many of ``ids`` go to each expert (what
    ``torch.bincount(ids, minlength=e)`` gives for ids below e, but of a
    size known without reading ``ids``, so it also runs on meta)."""
    flat = ids.reshape(-1)
    return torch.zeros(e, dtype=torch.long, device=ids.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.long))


def route(p: MoE, cfg: ModelConfig, x_flat) -> Tuple[torch.Tensor, ...]:
    """(expert ids [T,k], gates [T,k] renormalised over the k, aux) for
    tokens ``x_flat`` [T,d]: softmax router probabilities in fp32, top-k
    by a stable descending sort, and the Switch load-balance term E *
    sum_e (share of copies sent to e) * (mean probability of e)."""
    mo = cfg.moe
    k, e = mo.experts_per_token, mo.num_experts
    probs = torch.softmax(wide(x_flat) @ p.router, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    t = x_flat.shape[0]
    density = expert_counts(idx, e).float() / (t * k)
    aux = e * torch.sum(density * probs.mean(0))
    return idx, gate.to(x_flat.dtype), aux


def moe_forward(p: MoE, cfg: ModelConfig, x) -> Tuple[torch.Tensor, ...]:
    """x [B,S,d] -> (y [B,S,d], aux): every token of the call is routed
    together (capacity from B * S tokens)."""
    mo = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, mo.experts_per_token, mo.num_experts
    dev = x.device
    x_flat = x.reshape(t, d)
    idx, gate, aux = route(p, cfg, x_flat)

    # the k copies of every token, sorted by expert (stable: token order
    # within an expert)
    fe = idx.reshape(-1)
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    st = torch.arange(t, device=dev).repeat_interleave(k)[order]
    sg = gate.reshape(-1)[order]
    counts = expert_counts(fe, e)
    starts = torch.cumsum(counts, 0) - counts
    cap = capacity(t, cfg)
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot = se * cap + torch.where(keep, pos_in_e, 0)

    # dispatch: buffer row (expert, c) takes sorted copy starts[expert] + c
    bpos = torch.arange(e * cap, device=dev)
    b_e, b_c = bpos // cap, bpos % cap
    b_valid = b_c < counts[b_e]
    src_pos = torch.where(b_valid, starts[b_e] + b_c, 0)
    buf = torch.where(b_valid[:, None], x_flat[st[src_pos]], 0.0)
    buf = buf.reshape(e, cap, d)

    # the experts as grouped products over their buffers
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p.w_gate)) * torch.einsum(
        "ecd,edf->ecf", buf, p.w_up)
    h = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(e * cap, d)

    # combine: each copy's expert row times its gate (0 when dropped),
    # back in token order, the k copies summed
    gathered = h[slot] * (sg * keep)[:, None]
    contrib = gathered[torch.argsort(order)]
    y = contrib.reshape(t, k, d).sum(1).to(x.dtype)
    if p.shared is not None:
        y = y + mlp(p.shared, x_flat)
    return y.reshape(b, s, d), aux
