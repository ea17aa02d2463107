"""Plain reference of the Qwen2-MoE decoder (Qwen1.5-MoE), for the check.

The Qwen2 layer (``qwen2``) with its MLP replaced by a sparse block: a
softmax router over ``num_experts``, the ``num_experts_per_tok`` most probable
experts of each token (renormalised over those when ``norm_topk_prob``), each a
SwiGLU of width ``moe_intermediate_size``, plus one shared SwiGLU of width
``shared_expert_intermediate_size`` on every token, scaled by a sigmoid gate
(``shared_expert_gate``).  Both keys are read as served: the file's
``departures`` over the published values.  Every token
reaches every expert it picks: no capacity, no drops.  Plain ``torch`` in
float32; it imports nothing of the program.
"""
from __future__ import annotations

import torch

from specbench.reference import qwen2, served


def shared_gate(cfg: dict) -> bool:
    """Whether the shared expert is scaled by a sigmoid gate (the published
    block), or not (``departures.shared_expert_gate`` false)."""
    return bool(served(cfg, "shared_expert_gate", True))


def weight_spec(cfg: dict) -> list:
    s = qwen2.sizes(cfg)
    d, e = s["d"], cfg["num_experts"]
    f = cfg["moe_intermediate_size"]
    fs = cfg["shared_expert_intermediate_size"]
    out = qwen2.outer_spec(s)
    for i in range(s["layers"]):
        p = f"layers.{i}."
        out += qwen2.attention_spec(s, i)
        out += [(p + "router", (d, e), ("normal", d ** -0.5)),
                (p + "experts.w_gate", (e, d, f), ("normal", d ** -0.5)),
                (p + "experts.w_up", (e, d, f), ("normal", d ** -0.5)),
                (p + "experts.w_down", (e, f, d), ("normal", f ** -0.5))]
        out += qwen2.mlp_spec(p + "shared.", d, fs)
        if shared_gate(cfg):
            out.append((p + "shared_gate", (d, 1), ("normal", d ** -0.5)))
    return out


def ffn(w: dict, cfg: dict, s: dict, i: int, x):
    """Layer ``i``'s sparse block over x [S, d]."""
    p = f"layers.{i}."
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ w[p + "router"], -1)
    gate, idx = torch.topk(probs, k, -1)
    if served(cfg, "norm_topk_prob"):
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    wg, wu, wd = (w[p + "experts." + n] for n in ("w_gate", "w_up", "w_down"))
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        h = torch.nn.functional.silu(x[tok] @ wg[e]) * (x[tok] @ wu[e])
        y.index_add_(0, tok, (h @ wd[e]) * gate[tok, slot][:, None])
    shared = qwen2.mlp(w, p + "shared.", x)
    if shared_gate(cfg):
        shared = torch.sigmoid(x @ w[p + "shared_gate"]) * shared
    return y + shared


def logits(w: dict, cfg: dict, tokens) -> torch.Tensor:
    """Logits [S, V] at every position of ``tokens`` [S]."""
    return qwen2.logits(w, cfg, tokens, ffn_fn=ffn)
