#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as JSON objects, one per line:

  1. card      - device name, power limit (as nvidia-smi reports it) and
                 the kernels' build time from ``src/repro_torch/csrc``;
  2. kernels   - each hand-written kernel, in each of its modes (fp32 and
                 int8 K/V for the attention kernels), against its plain
                 PyTorch version on the card at the main path's shapes: max
                 errors against the stated tolerances, kernel / plain /
                 library times (CUDA events) and the least time the card
                 could take; and the dequant-matmul's M-independence (a row
                 gives the same bits at M = 1 as inside M = 8 or 128);
  3. serve     - the main path: ServingEngine(mode="pipedec") over the
                 paper's pair at published widths (target cut to 8 layers,
                 one per pipeline stage; seeded random weights), greedy
                 tokens checked against plain autoregressive decoding, and
                 the kernels' launch counts checked against the model calls;
  4. self-draft - draft = target: every tree prediction must hit;
  5. serve-int8 - the int8 path: the same pair and requests after
                 ``ModelBundle.quantize()`` (int8 projections through the
                 dequant-matmul kernel, int8 KV caches through the attention
                 kernels' int8 mode), checked against int8 autoregressive
                 decoding;
  6. self-draft-int8 - the int8 target as its own draft;
  7. cli       - ``repro_torch.launch.serve.main`` in pp and pipedec modes,
                 fp32 and ``--quant int8``, and the smoke pair on the card
                 against the same weights on the CPU, fp32 and int8.

Phases 3 to 6 and each CLI run set the kernels' launch counts to 0 just
before they run and check them just after against the model calls.

Then the per-kernel summary line and, last, the result line.  Any failed
check makes the exit code 1 and suppresses the result line.  Without CUDA,
or without the port's sources beside this file, it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks: HBM bandwidth and fp32 rate outside the tensor
# cores (the kernels use CUDA-core FMA only).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain tolerances: fp32 sums taken in another order.  The int8
# modes dequantize each row exactly as the plain versions do (float(q) *
# scale, one rounding), so they are held to the same tolerances.
TOL_O_ABS = 1e-4
TOL_M_REL = 1e-5
TOL_L_REL = 1e-4
# dequant_matmul vs plain: outputs of size about 1 (LeCun-normal weights,
# as in the model), fp32 sums over K taken in another order than cuBLAS's
TOL_DQ_ABS = 1e-4
# card vs CPU on the int8 smoke pair: a K/V value within an ulp of a
# rounding boundary may quantize one int8 step apart (fp32 sums differ in
# order), which moves a logit by up to about 1e-3
TOL_INT8_CARD_CPU = 1e-3
# near-tie rule of the lossless check: a token may differ from plain
# decoding only where the autoregressive top-2 logit margin is below this
NEAR_TIE = 1e-3

TARGET_LAYERS = 8        # one layer per stage of the paper's 8-stage pipeline
SERVE_REQUESTS = 4
SERVE_NEW_TOKENS = 32
SELF_DRAFT_NEW_TOKENS = 40
# projections per layer per forward call, each one dequant_matmul launch
PROJECTIONS = 7


def emit(obj) -> None:
    """Print one JSON object on its own line."""
    print(json.dumps(obj), flush=True)


def bail(msg: str) -> None:
    """Exit 1 before any result is printed."""
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _event_ms(run, batches: int, per_batch: int) -> float:
    import torch
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def cuda_ms(fn, batches: int = 21, per_batch: int = 10):
    """(device_ms, eager_ms) of one call of ``fn``, each the median over
    ``batches`` of the mean CUDA-event time of ``per_batch`` back-to-back
    calls.  device_ms replays the calls from a CUDA graph, so it is the
    card's time with the host's launch cost removed; eager_ms calls ``fn``
    from Python as the port does today, so a call that the host cannot
    launch as fast as the card runs it is timed at the host's rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = _event_ms(graph.replay, batches, per_batch)

    def eager():
        for _ in range(per_batch):
            fn()
    return device_ms, _event_ms(eager, batches, per_batch)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _bound(valid, b, h, kvh, n, hd, extra_bytes, int8=False):
    """Least time (ms) for attention over ``valid`` [B,n,L] (query may
    attend key): every input byte read once (q, the K/V rows some query of
    the batch row attends, at 1 byte an element plus 4 bytes of scale per
    row and KV head when ``int8``, ``extra_bytes`` of masks and bounds),
    every output byte written once (o, m, l); operations 4*hd per (head,
    query, key) pair that is attended (QK and PV), at the fp32 CUDA-core
    peak."""
    rows = int(valid.any(1).sum())                 # attended keys over B
    kv_row = 2 * (hd + 4) if int8 else 2 * 4 * hd
    nbytes = 4 * (2 * b * h * n * hd + 2 * b * h * n) + rows * kvh * kv_row
    nbytes += extra_bytes
    flops = 4 * hd * (h * int(valid.sum()))
    return _roofline(nbytes, flops)


def _roofline(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got, want):
    (o, m, l), (o2, m2, l2) = got, want
    err_o = float((o - o2).abs().max())
    err_m = float(((m - m2).abs() / m2.abs().clamp_min(1.0)).max())
    err_l = float(((l - l2).abs() / l2.abs().clamp_min(1e-30)).max())
    return err_o, err_m, err_l


# rows of the kernels line, one per kernel and mode: (name, source, the
# TPU kernel it replaces)
KERNEL_ROWS = (
    ("flash_attention_lse", "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/flash.py:102"),
    ("flash_attention_lse int8",
     "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/flash.py:102"),
    ("tree_block_attention", "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/tree_block.py:54"),
    ("tree_block_attention int8",
     "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/tree_block.py:54"),
    ("dequant_matmul", "src/repro_torch/csrc/dequant_matmul.cu",
     "src/repro/kernels/quant.py:113"),
)


def kernel_cases(torch, dev):
    """The phase-2 attention cases: (name, row, args dict); ``row`` names
    the kernel and mode (a KERNEL_ROWS entry)."""
    from repro_torch.kernels.quant import quantize_rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def kv(b, length, kvh, hd, int8):
        """K and V in the cache layout [B,L,KV,hd] as [B,KV,L,hd] views,
        int8 with [B,KV,L] scale views when ``int8``."""
        out = {}
        for name in ("k", "v"):
            x = rnd(b, length, kvh, hd)
            if int8:
                x, sc = quantize_rows(x)
                out[name + "_scale"] = sc.transpose(1, 2)
            out[name] = x.transpose(1, 2)
        return out

    def flash_case(name, b, h, kvh, n, hd, length, kv_len, *, causal=False,
                   window=0, main=False, int8=False):
        q = rnd(b, n, h, hd).transpose(1, 2)          # [B,H,n,hd] view
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        if causal:
            qpos = torch.arange(n, device=dev).expand(b, n)
        else:   # tree-layer positions: committed prefix + depth
            qpos = (kvl.long() - 1)[:, None] + torch.arange(n, device=dev) // 2
        row = "flash_attention_lse" + (" int8" if int8 else "")
        return name, row, dict(q=q, **kv(b, length, kvh, hd, int8),
                               kv_len=kvl, qpos=qpos.to(torch.int32),
                               causal=causal, window=window, main=main)

    def tree_case(name, b, h, kvh, n, hd, t, *, main=False, int8=False):
        q = rnd(b, n, h, hd).transpose(1, 2)
        mask = torch.rand(b, n, t, generator=gen, device=dev) < 0.3
        mask[:, -1] = False                           # an empty row
        row = "tree_block_attention" + (" int8" if int8 else "")
        return name, row, dict(q=q, **kv(b, t, kvh, hd, int8), mask=mask,
                               main=main)

    return [
        flash_case("flash/tree-past target B=1", 1, 64, 8, 8, 128, 512, [200],
                   main=True),
        flash_case("flash/tree-past target B=4", 4, 64, 8, 8, 128, 512,
                   [200, 37, 512, 0]),
        flash_case("flash/decode target", 1, 64, 8, 1, 128, 512, [200]),
        flash_case("flash/prefill causal S=128", 1, 64, 8, 128, 128, 128,
                   [128], causal=True),
        flash_case("flash/window 64", 1, 64, 8, 8, 128, 512, [300],
                   window=64),
        flash_case("flash/tree-past draft B=1", 1, 32, 8, 8, 64, 512, [200]),
        tree_case("tree/target B=1 T=105", 1, 64, 8, 8, 128, 105, main=True),
        tree_case("tree/target B=4 T=105", 4, 64, 8, 8, 128, 105),
        tree_case("tree/target B=1 T=73 (4 stages)", 1, 64, 8, 8, 128, 73),
        tree_case("tree/draft B=1 T=105", 1, 32, 8, 8, 64, 105),
        flash_case("flash int8/tree-past target B=1", 1, 64, 8, 8, 128, 512,
                   [200], main=True, int8=True),
        flash_case("flash int8/decode target", 1, 64, 8, 1, 128, 512, [200],
                   int8=True),
        flash_case("flash int8/prefill causal S=128", 1, 64, 8, 128, 128,
                   128, [128], causal=True, int8=True),
        flash_case("flash int8/tree-past draft B=1", 1, 32, 8, 8, 64, 512,
                   [200], int8=True),
        tree_case("tree int8/target B=1 T=105", 1, 64, 8, 8, 128, 105,
                  main=True, int8=True),
        tree_case("tree int8/draft B=1 T=105", 1, 32, 8, 8, 64, 105,
                  int8=True),
    ]


# (name, M, K, N, main): the projections of the main path.  Target: w_q
# and w_o (8192 x 8192), w_k/w_v (8192 x 1024), w_gate/w_up (8192 x 28672),
# w_down (28672 x 8192); draft: d 2048, ff 8192.  M = 8 is a tree verify
# (width 8), 1 a decode, 128 a prefill.
DQ_CASES = (
    ("dq/target w_q M=8", 8, 8192, 8192, False),
    ("dq/target w_k M=8", 8, 8192, 1024, False),
    ("dq/target w_gate M=8", 8, 8192, 28672, True),
    ("dq/target w_o M=8", 8, 8192, 8192, False),
    ("dq/target w_down M=8", 8, 28672, 8192, False),
    ("dq/target w_gate M=1", 1, 8192, 28672, False),
    ("dq/target w_gate M=128", 128, 8192, 28672, False),
    ("dq/draft w_q M=8", 8, 2048, 2048, False),
    ("dq/draft w_k M=8", 8, 2048, 512, False),
    ("dq/draft w_gate M=8", 8, 2048, 8192, False),
    ("dq/draft w_down M=8", 8, 8192, 2048, False),
)


def _summarise(summary, row_name, err, main, case, timing):
    s = summary.setdefault(row_name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if main:
        s.update(case=case, **timing)


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, tree_block
    from repro_torch.kernels.flash import dequant_kv, valid_mask
    dev = torch.device("cuda")
    summary = {}
    bad = []
    for name, row_name, a in kernel_cases(torch, dev):
        q, k, v = a["q"], a["k"], a["v"]
        b, h, n, hd = q.shape
        kvh, length = k.shape[1], k.shape[2]
        rep = h // kvh
        scale = 1.0 / hd ** 0.5
        qkw = {key: a[key] for key in ("k_scale", "v_scale") if key in a}
        int8 = bool(qkw)
        if row_name.startswith("flash"):
            def run(a=a, qkw=qkw):
                return flash.flash_attention_lse(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    causal=a["causal"], window=a["window"], **qkw)

            def plain(a=a, qkw=qkw):
                return flash.flash_attention_lse_plain(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    scale=scale, causal=a["causal"], window=a["window"],
                    **qkw)
            valid = valid_mask(b, n, length, a["kv_len"], a["qpos"],
                               a["causal"], a["window"], dev)
            extra = 4 * b + 4 * b * n
        else:
            def run(a=a, qkw=qkw):
                return tree_block.tree_block_attention(
                    a["q"], a["k"], a["v"], a["mask"], **qkw)

            def plain(a=a, qkw=qkw):
                return tree_block.tree_block_attention_plain(
                    a["q"], a["k"], a["v"], a["mask"], scale=scale, **qkw)
            valid = a["mask"]
            extra = b * n * length
        got = run()
        torch.cuda.synchronize()
        err_o, err_m, err_l = _errors(got, plain())
        ok = err_o <= TOL_O_ABS and err_m <= TOL_M_REL and err_l <= TOL_L_REL
        # the library yardstick: one SDPA call over the same mask, on the
        # fp32 K/V (int8: a dequantized fp32 copy, made outside the timing;
        # no PyTorch call takes int8 K/V with row scales)
        lib_k, lib_v = dequant_kv(k, v, qkw.get("k_scale"),
                                  qkw.get("v_scale"))
        lib_mask = valid[:, None]

        def library(q=q, k=lib_k, v=lib_v, lib_mask=lib_mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                  enable_gqa=rep > 1)
        bound_ms, bound_by = _bound(valid, b, h, kvh, n, hd, extra, int8)
        (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_eager = cuda_ms(library)
        row = {"phase": "kernels", "case": name, "kernel": row_name,
               "shapes": {"q": list(q.shape), "kv": list(k.shape),
                          "kv_dtype": str(k.dtype)},
               "max_abs_err": err_o, "m_rel_err": err_m, "l_rel_err": err_l,
               "tol": {"o_abs": TOL_O_ABS, "m_rel": TOL_M_REL,
                       "l_rel": TOL_L_REL},
               "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms,
               "library": "SDPA" + (" on a dequantized fp32 copy"
                                    if int8 else ""),
               "bound_ms": bound_ms, "bound_by": bound_by, "eager_ms": {
                   "kernel": k_eager, "plain": p_eager, "library": lib_eager}}
        emit(row)
        if not ok:
            bad.append(name)
        _summarise(summary, row_name, err_o, a["main"], name, dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
    bad += dequant_cases(torch, dev, summary)
    state["kernel_summary"] = summary
    if bad:
        raise AssertionError(f"kernels disagree with plain: {bad}")


def dequant_cases(torch, dev, summary):
    """dequant_matmul at the main path's shapes: kernel against plain,
    times, bound, and the M-independence check.  Returns failed cases."""
    from repro_torch.kernels import quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bad = []
    for name, m, k, n, main in DQ_CASES:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        q8, scale = quant.quantize_weight(w, 1)
        w_fp32 = quant.dequantize_weight(q8, scale)   # what fp32 serving holds
        del w

        def run(x=x, q8=q8, scale=scale):
            return quant.dequant_matmul(x, q8, scale)

        def plain(x=x, q8=q8, scale=scale):
            return quant.dequant_matmul_plain(x, q8, scale)

        def library(x=x, w_fp32=w_fp32):
            return torch.mm(x, w_fp32)
        got = run()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        # a row's bits must not depend on M: row 0 alone, and (M > 1) the
        # last row alone, against the same rows of the M-row call
        same_rows = all(torch.equal(quant.dequant_matmul(x[i:i + 1], q8,
                                                         scale)[0], got[i])
                        for i in sorted({0, m - 1}))
        ok = err <= TOL_DQ_ABS and same_rows
        bound_ms, bound_by = _roofline(k * n + 4 * n + 4 * m * k + 4 * m * n,
                                       2 * m * k * n)
        (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_eager = cuda_ms(library)
        splits, chunk = quant.k_split(k, n)
        emit({"phase": "kernels", "case": name, "kernel": "dequant_matmul",
              "shapes": {"x": [m, k], "w_q": [k, n]},
              "k_splits": splits, "k_per_split": chunk,
              "max_abs_err": err, "tol": {"abs": TOL_DQ_ABS},
              "m1_bit_equal": same_rows, "ok": ok, "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": lib_ms,
              "library": "torch.mm on the dequantized fp32 weight (what "
                         "the fp32 path pays through cuBLAS)",
              "bound_ms": bound_ms, "bound_by": bound_by,
              "eager_ms": {"kernel": k_eager, "plain": p_eager,
                           "library": lib_eager}})
        if not ok:
            bad.append(name)
        _summarise(summary, "dequant_matmul", err, main, name, dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        del x, q8, scale, w_fp32
    return bad


# ---------------------------------------------------------------------------
# launch counts: zeroed before a path runs, checked against its model calls
# ---------------------------------------------------------------------------
def _counters():
    """(row name, wrapper, counter attribute) of every KERNEL_ROWS entry."""
    from repro_torch.kernels import flash, quant, tree_block
    return (("flash_attention_lse", flash.flash_attention_lse, "launches"),
            ("flash_attention_lse int8", flash.flash_attention_lse,
             "launches_int8"),
            ("tree_block_attention", tree_block.tree_block_attention,
             "launches"),
            ("tree_block_attention int8", tree_block.tree_block_attention,
             "launches_int8"),
            ("dequant_matmul", quant.dequant_matmul, "launches"))


def zero_launches(*bundles):
    """Set every kernel's launch counts and the bundles' call counts to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
    for b in bundles:
        if b is not None:
            b.calls.clear()


def read_launches(*bundles):
    """(launches, expected): the kernels' counts by KERNEL_ROWS name, and
    what the bundles' calls imply.  Each forward pass launches flash once
    per layer, and each tree verify the tree kernel once per layer, in
    their int8 mode for an int8 bundle; each forward pass of an int8
    bundle also launches dequant_matmul once per projection of each layer.
    A bundle that serves as both target and draft is counted once."""
    launches = {row: getattr(fn, attr) for row, fn, attr in _counters()}
    expect = dict.fromkeys(launches, 0)
    uniq = {id(b): b for b in bundles if b is not None}.values()
    for b in uniq:
        layers, calls = b.cfg.num_layers, b.calls
        forward = sum(calls.get(k, 0)
                      for k in ("prefill", "decode", "tree_verify"))
        int8 = b.cfg.quant == "int8"
        mode = " int8" if int8 else ""
        expect["flash_attention_lse" + mode] += layers * forward
        expect["tree_block_attention" + mode] += \
            layers * calls.get("tree_verify", 0)
        if int8:
            expect["dequant_matmul"] += PROJECTIONS * layers * forward
    return launches, expect


def launches_ok(launches, expect, used):
    """Counts equal what the calls imply, and every kernel of ``used``
    (the path's kernels) ran."""
    return launches == expect and all(launches[k] for k in used)


FP32_PATH = ("flash_attention_lse", "tree_block_attention")
INT8_PATH = ("flash_attention_lse int8", "tree_block_attention int8",
             "dequant_matmul")


# ---------------------------------------------------------------------------
# phase 3: full-width serving, the main path
# ---------------------------------------------------------------------------
def _margin(bundle, prefix):
    """Top-2 logit margin of the next-token prediction after ``prefix``."""
    import numpy as np
    import torch
    cache = bundle.init_cache(1, len(prefix) + 1)
    logits, _ = bundle.prefill(np.asarray(prefix, np.int64)[None], cache)
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def _lossless(bundle, prompt, got, want):
    """Compare speculative ``got`` with autoregressive ``want`` tokens;
    returns (ok, near_tie_position or None)."""
    for i, (x, y) in enumerate(zip(got.tolist(), want.tolist())):
        if x == y:
            continue
        margin = _margin(bundle, list(prompt) + want.tolist()[:i])
        return margin < NEAR_TIE, {"position": i, "margin": margin}
    return len(got) == len(want), None


def _serve(phase, state, target, draft, path, extra):
    """The main path's serving run: the phase-3 requests through
    ServingEngine(mode="pipedec"), 8 stages, width 8, branch 4; tokens
    checked against autoregressive decoding of ``target`` (near-tie rule),
    launch counts against the model calls, with every kernel of ``path``
    launched.  Emits the phase line; raises if a check fails."""
    import numpy as np
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.serving import Request, ServingEngine

    rng = np.random.default_rng(0)
    lens = [64, 96, 128, 80][:SERVE_REQUESTS]
    prompts = [rng.integers(0, target.cfg.vocab_size, size=s).astype(
        np.int64) for s in lens]
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    engine = ServingEngine(target, draft, mode="pipedec", pipedec=pcfg,
                           max_len=256)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, SERVE_NEW_TOKENS))

    zero_launches(target, draft)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state["launches"].update({k: launches[k] for k in path})
    tc, dc = dict(target.calls), dict(draft.calls)

    rows, ok = [], launches_ok(launches, expect, path)
    for uid, p in enumerate(prompts):
        res = results[uid]
        want = generate_autoregressive(target, p, SERVE_NEW_TOKENS,
                                       max_len=256)
        same, tie = _lossless(target, p, res.tokens, want)
        ok = ok and same
        st = res.stats
        rows.append({"uid": uid, "prompt_len": len(p),
                     "latency_s": res.latency_s,
                     "acceptance": st.acceptance,
                     "tokens_per_timestep": st.tokens_per_timestep,
                     "timesteps": st.timesteps, "hits": st.hits,
                     "misses": st.misses, "lossless": same,
                     "near_tie": tie})
    emit({"phase": phase, "ok": ok, "mode": "pipedec",
          "quant": target.cfg.quant or "none",
          "target": target.cfg.name, "draft": draft.cfg.name,
          "reduced": {"target_layers": f"{target.cfg.num_layers} of "
                      f"{pipedec_pair.TARGET.num_layers}"},
          "pipedec": {"n_stages": 8, "width": 8, "branch": 4},
          "new_tokens": SERVE_NEW_TOKENS, **extra, "serve_s": serve_s,
          "timesteps": sum(r["timesteps"] for r in rows),
          "peak_mem_gb": peak_gb, "calls": {"target": tc, "draft": dc},
          "launches": launches, "expected_launches": expect,
          "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its line")


def phase_serve(state):
    import dataclasses
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf

    tcfg = dataclasses.replace(pipedec_pair.TARGET, num_layers=TARGET_LAYERS)
    t0 = time.perf_counter()
    target = ModelBundle(tf.init_model(tcfg, seed=0, device="cuda"))
    draft = ModelBundle(tf.init_model(pipedec_pair.DRAFT, seed=1,
                                      device="cuda"))
    torch.cuda.synchronize()
    state["target"] = target
    _serve("serve", state, target, draft, FP32_PATH,
           {"init_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 4 (and 6): self-draft (every prediction hits)
# ---------------------------------------------------------------------------
def _self_draft(phase, target, path):
    import numpy as np
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    eng = PipeDecEngine(target, target,
                        PipeDecConfig(n_stages=4, width=8, branch=4))
    zero_launches(target)
    t0 = time.perf_counter()
    out, st = eng.generate(np.array([3, 3, 8]), SELF_DRAFT_NEW_TOKENS)
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target)
    counted = launches_ok(launches, expect, path)
    ok = st.acceptance == 1.0 and st.tokens_per_timestep > 0.75 and counted
    emit({"phase": phase, "ok": ok, "quant": target.cfg.quant or "none",
          "acceptance": st.acceptance,
          "tokens_per_timestep": st.tokens_per_timestep,
          "timesteps": st.timesteps, "commits": st.commits,
          "commits_per_step": "".join(map(str, st.commits_per_step)),
          "calls": dict(target.calls), "launches": launches,
          "expected_launches": expect, "wall_s": wall_s})
    if not ok:
        raise AssertionError(f"{phase}: acceptance must be 1.0, "
                             "tokens/timestep > 0.75 and launches as expected")


def phase_self_draft(state):
    _self_draft("self-draft", state["target"], FP32_PATH)


# ---------------------------------------------------------------------------
# phase 5: the int8 serving path at full width
# ---------------------------------------------------------------------------
def phase_serve_int8(state):
    """Quantize phase 3's fp32 target on the card and free its fp32
    projections before the int8 draft is made, so the fp32 pair never
    lives beside the int8 one (peak about 36 + 15 GB while the target is
    quantized)."""
    import gc
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fp32 = state.pop("target")
    target = fp32.quantize()
    del fp32
    draft = ModelBundle(tf.init_model(pipedec_pair.DRAFT, seed=1,
                                      device="cuda")).quantize()
    gc.collect()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantize_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    state["target_int8"] = target
    _serve("serve-int8", state, target, draft, INT8_PATH,
           {"quantize_s": quantize_s, "quantize_peak_mem_gb":
            quantize_peak_gb, "resident_gb":
            torch.cuda.memory_allocated() / 1e9})


def phase_self_draft_int8(state):
    _self_draft("self-draft-int8", state["target_int8"], INT8_PATH)


# ---------------------------------------------------------------------------
# phase 7: the CLI, and the card against the CPU on the same weights
# ---------------------------------------------------------------------------
CLI_RUNS = (  # (mode, --quant, the kernels that run on that path)
    ("pp", "none", ("flash_attention_lse",)),   # pp decodes without a tree
    ("pipedec", "none", FP32_PATH),
    ("pp", "int8", ("flash_attention_lse int8", "dequant_matmul")),
    ("pipedec", "int8", INT8_PATH),
)


def _card_vs_cpu(quant, tol):
    """The smoke pair with the same weights on the card and on the CPU
    (int8: each quantized on its own device): prefill logits within
    ``tol``, equal int8 weights, equal PipeDec tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf

    pcfg = PipeDecConfig(n_stages=4, width=8, branch=4)
    pair = ((pipedec_pair.TARGET_SMOKE, 0), (pipedec_pair.DRAFT_SMOKE, 1))
    cpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu"))
           for c, s in pair]
    gpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu").to("cuda"))
           for c, s in pair]
    weights_equal = True
    if quant == "int8":
        cpu = [b.quantize() for b in cpu]
        gpu = [b.quantize() for b in gpu]
        weights_equal = all(
            torch.equal(wc.cpu(), wg.cpu()) for bc, bg in zip(cpu, gpu)
            for wc, wg in zip(bc.model.buffers(), bg.model.buffers()))
    prompt = np.random.default_rng(1).integers(0, 512, size=16)
    l_cpu, _ = cpu[0].prefill(prompt[None], cpu[0].init_cache(1, 32))
    l_gpu, _ = gpu[0].prefill(prompt[None], gpu[0].init_cache(1, 32))
    err = float((l_cpu - l_gpu.cpu()).abs().max())
    out_cpu, _ = PipeDecEngine(*cpu, pcfg).generate(prompt, 16)
    out_gpu, _ = PipeDecEngine(*gpu, pcfg).generate(prompt, 16)
    same = bool(np.array_equal(out_cpu, out_gpu))
    good = err <= tol and same and weights_equal
    emit({"phase": "cli", "check": "card vs CPU, smoke pair, same weights",
          "quant": quant, "ok": good, "prefill_logits_max_abs_err": err,
          "tol": tol, "int8_weights_equal": weights_equal,
          "pipedec_tokens_equal": same})
    return good


def phase_cli(state):
    import gc
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.launch import serve

    state.pop("target", None)
    state.pop("target_int8", None)
    gc.collect()
    torch.cuda.empty_cache()
    ok = True
    for mode, quant, used in CLI_RUNS:
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            engine, res = serve.main(["--mode", mode, "--requests", "3",
                                      "--new-tokens", "12", "--quant", quant])
        wall_s = time.perf_counter() - t0
        launches, expect = read_launches(engine.target, engine.draft)
        good = len(res) == 3 and all(
            len(r.tokens) == 13 and (r.tokens >= 0).all()
            and (r.tokens < pipedec_pair.TARGET_SMOKE.vocab_size).all()
            for r in res.values())
        good = good and launches_ok(launches, expect, used)
        ok = ok and good
        emit({"phase": "cli", "mode": mode, "quant": quant, "ok": good,
              "wall_s": wall_s,
              "calls": {"target": dict(engine.target.calls),
                        "draft": dict(engine.draft.calls)
                        if engine.draft is not None else None},
              "launches": launches, "expected_launches": expect,
              "printed": buf.getvalue().strip().splitlines()})

    good = _card_vs_cpu("none", 1e-4)
    good = _card_vs_cpu("int8", TOL_INT8_CARD_CPU) and good
    if not (ok and good):
        raise AssertionError("cli phase failed: see its lines")


# ---------------------------------------------------------------------------
def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        bail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    try:
        import torch
    except ImportError:
        bail("PyTorch is not installed")
    if not torch.cuda.is_available():
        bail("CUDA is not available: this script runs the port on one "
             "NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    reports = build.build(build.KERNELS)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    emit({"phase": "card", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    state, failed = {"launches": {}}, []
    for name, phase in (("kernels", phase_kernels), ("serve", phase_serve),
                        ("self-draft", phase_self_draft),
                        ("serve-int8", phase_serve_int8),
                        ("self-draft-int8", phase_self_draft_int8),
                        ("cli", phase_cli)):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception as exc:   # record, run the other phases, exit 1
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(exc)})
        emit({"phase": name, "done_s": time.perf_counter() - t0})

    summary = state.get("kernel_summary", {})
    launches = state.get("launches", {})
    rows = []
    for name, src, replaces in KERNEL_ROWS:
        s = summary.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": s.get("max_abs_err"), "ms": s.get("ms"),
                     "plain_ms": s.get("plain_ms"),
                     "bound_ms": s.get("bound_ms"),
                     "bound_by": s.get("bound_by"),
                     "library_ms": s.get("library_ms"),
                     "case": s.get("case")})
    emit({"kernels": rows})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
