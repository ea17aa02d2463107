"""The yardstick's arithmetic: published peaks, model FLOPs of the useful rows,
and the least time of a paged attention call.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at the
700 W limit).  The least-time arithmetic is a frozen copy of the kernel
table's (every input byte read once and every output byte written once at
the HBM rate; the attention kernels' fp32 products are three TF32 products
on the tensor cores, at the TF32 rate).
"""
from __future__ import annotations

import numpy as np

from specbench.reference import served

FP32_FLOP_PER_S = 67e12       # IEEE fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
TF32_PASSES = 3


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, h=h, kv=cfg["num_key_value_heads"], hd=d // h,
                layers=cfg["num_hidden_layers"], v=cfg["vocab_size"])


def token_flops(cfg: dict) -> float:
    """FLOPs of one token through one layer's products, attention scores
    aside: q/k/v/o projections and the MLP, or for a sparse layer the router,
    the ``num_experts_per_tok`` experts the token reaches and the shared
    expert (with its gate when the file has one)."""
    s = dims(cfg)
    d, hd = s["d"], s["hd"]
    f = 2 * d * (s["h"] + 2 * s["kv"]) * hd + 2 * s["h"] * hd * d
    if "num_experts" in cfg:
        gate = served(cfg, "shared_expert_gate", True)
        f += 2 * d * cfg["num_experts"]
        f += cfg["num_experts_per_tok"] * 6 * d * cfg["moe_intermediate_size"]
        f += 6 * d * cfg["shared_expert_intermediate_size"]
        f += 2 * d if gate else 0
    else:
        f += 6 * d * cfg["intermediate_size"]
    return float(f)


def score_flops(cfg: dict, keys) -> float:
    """QK and PV FLOPs of one query per layer over ``keys`` keys."""
    s = dims(cfg)
    return 4.0 * s["hd"] * s["h"] * float(np.sum(keys))


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def verify_flops(cfg: dict, model_len, masks, row_on) -> float:
    """One model's tree verify: every valid node of a pending slot (a node
    attends its slot's ``model_len`` committed rows and its ancestors in the
    tree, ``masks`` [slots, w, T] host bool), through every layer and the
    head.  Padded nodes and the rows of other slots count nothing."""
    m = np.asarray(masks, bool) & np.asarray(row_on, bool)[:, None, None]
    anc = m.sum(-1)                                   # [slots, w]
    valid = anc > 0
    rows = int(valid.sum())
    keys = (np.asarray(model_len, np.int64)[:, None] + anc)[valid]
    s = dims(cfg)
    return s["layers"] * (rows * token_flops(cfg) + score_flops(cfg, keys)) \
        + rows * head_flops(cfg)


def prefill_flops(cfg: dict, n: int) -> float:
    """One model's prefill of an n-token prompt: every token through every
    layer, causal scores, and the head at the last position."""
    s = dims(cfg)
    scores = score_flops(cfg, n * (n + 1) / 2)
    return s["layers"] * (n * token_flops(cfg) + scores) + head_flops(cfg)


def least_s(nbytes: float, flops: float) -> float:
    """Least time of a call: the larger of its bytes at the HBM rate and its
    operations (TF32 products) at the TF32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOP_PER_S)


def paged_flash_least_s(q_shape, kvh: int, mb: int, kv_len) -> float:
    """The committed-prefix half of a tree verify (``paged_flash_attention_
    lse`` with no causal mask and no window): each batch row's queries
    attend its ``kv_len`` rows.  Reads q, the attended K/V rows, the block
    table, kv_len and qpos; writes o, m, l."""
    b, h, n, hd = q_shape
    kv = np.asarray(kv_len, np.int64).reshape(-1)
    pairs = h * n * int(kv.sum())
    nbytes = 4 * (b * h * n * hd + int(kv.sum()) * kvh * 2 * hd + b * mb
                  + b + b * n) + 4 * (b * h * n * hd + 2 * b * h * n)
    return least_s(nbytes, TF32_PASSES * 4 * hd * pairs)


def paged_tree_least_s(q_shape, kvh: int, mb: int, mask,
                       merged: bool) -> float:
    """A tree half (``paged_tree_block_attention``) over ``mask`` [B, n, T]
    (host bool): reads q, the tree K/V rows some query of the row attends,
    the mask, the table and, ``merged``, the past half's (o, m, l); writes o
    (and m, l when not merged)."""
    b, h, n, hd = q_shape
    m = np.asarray(mask, bool)
    pairs = h * int(m.sum())
    rows = int(m.any(1).sum())
    nbytes = 4 * (b * h * n * hd + rows * kvh * 2 * hd + b * mb) + m.size
    nbytes += 4 * (b * h * n * hd + 2 * b * h * n) if merged else 0
    nbytes += 4 * b * h * n * hd + (0 if merged else 8 * b * h * n)
    return least_s(nbytes, TF32_PASSES * 4 * hd * pairs)
