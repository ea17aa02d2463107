"""Plain reference of the Qwen2 decoder (Qwen2.5), for the benchmark's check.

What a configuration file of ``model_type`` "qwen2" states: token embedding,
pre-norm decoder layers (RMSNorm, grouped-query attention with biases on the
q/k/v projections and half-split rotary embeddings, RMSNorm, SwiGLU MLP), a
final RMSNorm and an untied head.  Plain ``torch`` in float32, one sequence at
a time, no cache, no batching, no kernel; it imports nothing of the program.

Weights are a dict of tensors by the names of ``weight_spec``; the harness
draws them and hands the same tensors to the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sizes(cfg: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, h=h, kv=cfg["num_key_value_heads"], hd=d // h,
                ff=cfg["intermediate_size"], v=cfg["vocab_size"],
                layers=cfg["num_hidden_layers"], eps=cfg["rms_norm_eps"],
                theta=cfg["rope_theta"])


def attention_spec(s: dict, i: int) -> list:
    """(name, shape, init) of one layer's norm and attention weights; init is
    ("normal", std) or ("one_plus", std): 1 + std * N(0, 1)."""
    d, h, kv, hd = s["d"], s["h"], s["kv"], s["hd"]
    p = f"layers.{i}."
    return [(p + "norm1", (d,), ("one_plus", 0.05)),
            (p + "wq", (d, h, hd), ("normal", d ** -0.5)),
            (p + "bq", (h, hd), ("normal", 0.1)),
            (p + "wk", (d, kv, hd), ("normal", d ** -0.5)),
            (p + "bk", (kv, hd), ("normal", 0.1)),
            (p + "wv", (d, kv, hd), ("normal", d ** -0.5)),
            (p + "bv", (kv, hd), ("normal", 0.1)),
            (p + "wo", (h, hd, d), ("normal", (h * hd) ** -0.5)),
            (p + "norm2", (d,), ("one_plus", 0.05))]


def mlp_spec(prefix: str, d: int, ff: int) -> list:
    """A SwiGLU MLP's weights."""
    return [(prefix + "w_gate", (d, ff), ("normal", d ** -0.5)),
            (prefix + "w_up", (d, ff), ("normal", d ** -0.5)),
            (prefix + "w_down", (ff, d), ("normal", ff ** -0.5))]


def outer_spec(s: dict) -> list:
    """Embedding, final norm and head."""
    return [("embed", (s["v"], s["d"]), ("normal", 0.02)),
            ("final_norm", (s["d"],), ("one_plus", 0.05)),
            ("head", (s["v"], s["d"]), ("normal", 0.02))]


def weight_spec(cfg: dict) -> list:
    """Every weight of the model as (name, shape, init)."""
    s = sizes(cfg)
    out = outer_spec(s)
    for i in range(s["layers"]):
        out += attention_spec(s, i) + mlp_spec(f"layers.{i}.mlp.", s["d"],
                                               s["ff"])
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x [S, heads, hd] at positions 0..S-1, rotated half against half."""
    s, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(w: dict, s: dict, i: int, x, block: int = 512):
    """Causal grouped-query self-attention of layer ``i`` over x [S, d]."""
    p = f"layers.{i}."
    n, d, h, kv, hd = x.shape[0], s["d"], s["h"], s["kv"], s["hd"]
    q = (x @ w[p + "wq"].reshape(d, h * hd)).view(n, h, hd) + w[p + "bq"]
    k = (x @ w[p + "wk"].reshape(d, kv * hd)).view(n, kv, hd) + w[p + "bk"]
    v = (x @ w[p + "wv"].reshape(d, kv * hd)).view(n, kv, hd) + w[p + "bv"]
    q, k = rope(q, s["theta"]), rope(k, s["theta"])
    rep = h // kv
    k = k.repeat_interleave(rep, 1).transpose(0, 1)      # [h, S, hd]
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(n, device=x.device)
    for a in range(0, n, block):                          # query blocks
        b = min(n, a + block)
        logits = q[:, a:b] @ k[:, :b].transpose(1, 2) / math.sqrt(hd)
        mask = keys[None, :b] <= keys[a:b, None]
        logits = logits.masked_fill(~mask, float("-inf"))
        out[:, a:b] = torch.softmax(logits, -1) @ v[:, :b]
    out = out.transpose(0, 1).reshape(n, h * hd)
    return out @ w[p + "wo"].reshape(h * hd, d)


def mlp(w: dict, prefix: str, x):
    return (F.silu(x @ w[prefix + "w_gate"]) * (x @ w[prefix + "w_up"])) \
        @ w[prefix + "w_down"]


def ffn(w: dict, cfg: dict, s: dict, i: int, x):
    """Layer ``i``'s feed-forward block."""
    return mlp(w, f"layers.{i}.mlp.", x)


def logits(w: dict, cfg: dict, tokens, ffn_fn=ffn) -> torch.Tensor:
    """Logits [S, V] at every position of ``tokens`` [S] (int64)."""
    s = sizes(cfg)
    x = w["embed"][tokens]
    for i in range(s["layers"]):
        p = f"layers.{i}."
        x = x + attention(w, s, i, rmsnorm(x, w[p + "norm1"], s["eps"]))
        x = x + ffn_fn(w, cfg, s, i, rmsnorm(x, w[p + "norm2"], s["eps"]))
    return rmsnorm(x, w["final_norm"], s["eps"]) @ w["head"].T
