#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as JSON objects, one per line:

  1. card      - device name, power limit (as nvidia-smi reports it) and
                 the kernels' build time from ``src/repro_torch/csrc``;
  2. kernels   - each hand-written kernel against its plain PyTorch version
                 on the card at the main path's shapes: max errors against
                 the stated tolerances, kernel / plain / library times
                 (CUDA events) and the least time the card could take;
  3. serve     - the main path: ServingEngine(mode="pipedec") over the
                 paper's pair at published widths (target cut to 8 layers,
                 one per pipeline stage; seeded random weights), greedy
                 tokens checked against plain autoregressive decoding, and
                 the kernels' launch counts checked against the model calls;
  4. self-draft - draft = target: every tree prediction must hit;
  5. cli       - ``repro_torch.launch.serve.main`` in pp and pipedec modes,
                 and the smoke pair on the card against the same weights on
                 the CPU.

Phases 3, 4 and each CLI mode set the kernels' launch counts to 0 just
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

# kernel vs plain tolerances: fp32 sums taken in another order
TOL_O_ABS = 1e-4
TOL_M_REL = 1e-5
TOL_L_REL = 1e-4
# near-tie rule of the lossless check: a token may differ from plain
# decoding only where the autoregressive top-2 logit margin is below this
NEAR_TIE = 1e-3

TARGET_LAYERS = 8        # one layer per stage of the paper's 8-stage pipeline
SERVE_REQUESTS = 4
SERVE_NEW_TOKENS = 32
SELF_DRAFT_NEW_TOKENS = 40


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
def _bound(valid, b, h, kvh, n, hd, extra_bytes):
    """Least time (ms) for attention over ``valid`` [B,n,L] (query may
    attend key): every input byte read once (q, the K/V rows some query of
    the batch row attends, ``extra_bytes`` of masks and bounds), every
    output byte written once (o, m, l); operations 4*hd per (head, query,
    key) pair that is attended (QK and PV), at the fp32 CUDA-core peak."""
    rows = int(valid.any(1).sum())                 # attended keys over B
    nbytes = 4 * (2 * b * h * n * hd + 2 * b * h * n + 2 * rows * kvh * hd)
    nbytes += extra_bytes
    flops = 4 * hd * (h * int(valid.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got, want):
    (o, m, l), (o2, m2, l2) = got, want
    err_o = float((o - o2).abs().max())
    err_m = float(((m - m2).abs() / m2.abs().clamp_min(1.0)).max())
    err_l = float(((l - l2).abs() / l2.abs().clamp_min(1e-30)).max())
    return err_o, err_m, err_l


def kernel_cases(torch, dev):
    """The phase-2 cases: (name, kernel, args dict)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def flash_case(name, b, h, kvh, n, hd, length, kv_len, *, causal=False,
                   window=0, main=False):
        q = rnd(b, n, h, hd).transpose(1, 2)          # [B,H,n,hd] view
        k = rnd(b, length, kvh, hd).transpose(1, 2)   # cache layout, view
        v = rnd(b, length, kvh, hd).transpose(1, 2)
        kv = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        if causal:
            qpos = torch.arange(n, device=dev).expand(b, n)
        else:   # tree-layer positions: committed prefix + depth
            qpos = (kv.long() - 1)[:, None] + torch.arange(n, device=dev) // 2
        return name, "flash_attention_lse", dict(
            q=q, k=k, v=v, kv_len=kv, qpos=qpos.to(torch.int32),
            causal=causal, window=window, main=main)

    def tree_case(name, b, h, kvh, n, hd, t, *, main=False):
        q = rnd(b, n, h, hd).transpose(1, 2)
        k = rnd(b, t, kvh, hd).transpose(1, 2)
        v = rnd(b, t, kvh, hd).transpose(1, 2)
        mask = torch.rand(b, n, t, generator=gen, device=dev) < 0.3
        mask[:, -1] = False                           # an empty row
        return name, "tree_block_attention", dict(q=q, k=k, v=v, mask=mask,
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
    ]


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, tree_block
    from repro_torch.kernels.flash import valid_mask
    dev = torch.device("cuda")
    summary = {}
    for name, kernel, a in kernel_cases(torch, dev):
        q, k, v = a["q"], a["k"], a["v"]
        b, h, n, hd = q.shape
        kvh, length = k.shape[1], k.shape[2]
        rep = h // kvh
        scale = 1.0 / hd ** 0.5
        if kernel == "flash_attention_lse":
            def run(a=a):
                return flash.flash_attention_lse(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    causal=a["causal"], window=a["window"])

            def plain(a=a):
                return flash.flash_attention_lse_plain(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    scale=scale, causal=a["causal"], window=a["window"])
            valid = valid_mask(b, n, length, a["kv_len"], a["qpos"],
                           a["causal"], a["window"], dev)
            extra = 4 * b + 4 * b * n
        else:
            def run(a=a):
                return tree_block.tree_block_attention(a["q"], a["k"],
                                                       a["v"], a["mask"])

            def plain(a=a):
                return tree_block.tree_block_attention_plain(
                    a["q"], a["k"], a["v"], a["mask"], scale=scale)
            valid = a["mask"]
            extra = b * n * length
        got = run()
        torch.cuda.synchronize()
        err_o, err_m, err_l = _errors(got, plain())
        ok = err_o <= TOL_O_ABS and err_m <= TOL_M_REL and err_l <= TOL_L_REL
        # the library yardstick: one SDPA call over the same inputs and mask
        lib_mask = valid[:, None]

        def library(q=q, k=k, v=v, lib_mask=lib_mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                  enable_gqa=rep > 1)
        bound_ms, bound_by = _bound(valid, b, h, kvh, n, hd, extra)
        (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_eager = cuda_ms(library)
        row = {"phase": "kernels", "case": name, "kernel": kernel,
               "shapes": {"q": list(q.shape), "kv": list(k.shape)},
               "max_abs_err": err_o, "m_rel_err": err_m, "l_rel_err": err_l,
               "tol": {"o_abs": TOL_O_ABS, "m_rel": TOL_M_REL,
                       "l_rel": TOL_L_REL},
               "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "eager_ms": {
                   "kernel": k_eager, "plain": p_eager, "library": lib_eager}}
        emit(row)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain")
        s = summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err_o)
        if a["main"]:
            s.update(case=name, ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=row["library_ms"])
    state["kernel_summary"] = summary


# ---------------------------------------------------------------------------
# launch counts: zeroed before a path runs, checked against its model calls
# ---------------------------------------------------------------------------
def zero_launches(*bundles):
    """Set both kernels' launch counts and the bundles' call counts to 0."""
    from repro_torch.kernels import flash, tree_block
    flash.flash_attention_lse.launches = 0
    tree_block.tree_block_attention.launches = 0
    for b in bundles:
        if b is not None:
            b.calls.clear()


def read_launches(*bundles):
    """(launches, expected): the kernels' counts, and what the bundles'
    calls imply.  Each forward pass launches flash once per layer; each
    tree verify also launches the tree kernel once per layer.  A bundle
    that serves as both target and draft is counted once."""
    from repro_torch.kernels import flash, tree_block
    launches = {"flash_attention_lse": flash.flash_attention_lse.launches,
                "tree_block_attention":
                    tree_block.tree_block_attention.launches}
    uniq = {id(b): b for b in bundles if b is not None}.values()
    expect = {"flash_attention_lse": 0, "tree_block_attention": 0}
    for b in uniq:
        layers, calls = b.cfg.num_layers, b.calls
        expect["flash_attention_lse"] += layers * sum(
            calls.get(k, 0) for k in ("prefill", "decode", "tree_verify"))
        expect["tree_block_attention"] += layers * calls.get("tree_verify", 0)
    return launches, expect


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


def phase_serve(state):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine

    tcfg = dataclasses.replace(pipedec_pair.TARGET, num_layers=TARGET_LAYERS)
    dcfg = pipedec_pair.DRAFT
    t0 = time.perf_counter()
    target = ModelBundle(tf.init_model(tcfg, seed=0, device="cuda"))
    draft = ModelBundle(tf.init_model(dcfg, seed=1, device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state["target"] = target

    rng = np.random.default_rng(0)
    lens = [64, 96, 128, 80][:SERVE_REQUESTS]
    prompts = [rng.integers(0, tcfg.vocab_size, size=s).astype(np.int64)
               for s in lens]
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
    state["launches"] = launches
    tl = tcfg.num_layers
    tc, dc = dict(target.calls), dict(draft.calls)

    rows, ok = [], launches == expect and all(launches.values())
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
    emit({"phase": "serve", "ok": ok, "mode": "pipedec",
          "target": tcfg.name, "draft": dcfg.name,
          "reduced": {"target_layers": f"{tl} of "
                      f"{pipedec_pair.TARGET.num_layers}"},
          "pipedec": {"n_stages": 8, "width": 8, "branch": 4},
          "new_tokens": SERVE_NEW_TOKENS, "init_s": init_s,
          "serve_s": serve_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "calls": {"target": tc, "draft": dc},
          "launches": launches, "expected_launches": expect,
          "requests": rows})
    if not ok:
        raise AssertionError("serve phase failed: see its line")
    del draft, engine


# ---------------------------------------------------------------------------
# phase 4: self-draft (every prediction hits)
# ---------------------------------------------------------------------------
def phase_self_draft(state):
    import numpy as np
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    target = state["target"]
    eng = PipeDecEngine(target, target,
                        PipeDecConfig(n_stages=4, width=8, branch=4))
    zero_launches(target)
    t0 = time.perf_counter()
    out, st = eng.generate(np.array([3, 3, 8]), SELF_DRAFT_NEW_TOKENS)
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target)
    counted = launches == expect and all(launches.values())
    ok = st.acceptance == 1.0 and st.tokens_per_timestep > 0.75 and counted
    emit({"phase": "self-draft", "ok": ok, "acceptance": st.acceptance,
          "tokens_per_timestep": st.tokens_per_timestep,
          "timesteps": st.timesteps, "commits": st.commits,
          "commits_per_step": "".join(map(str, st.commits_per_step)),
          "calls": dict(target.calls), "launches": launches,
          "expected_launches": expect, "wall_s": wall_s})
    if not ok:
        raise AssertionError("self-draft: acceptance must be 1.0, "
                             "tokens/timestep > 0.75 and launches as expected")


# ---------------------------------------------------------------------------
# phase 5: the CLI, and the card against the CPU on the same weights
# ---------------------------------------------------------------------------
def phase_cli(state):
    import numpy as np
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    state.pop("target", None)
    torch.cuda.empty_cache()
    ok = True
    for mode in ("pp", "pipedec"):
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            engine, res = serve.main(["--mode", mode, "--requests", "3",
                                      "--new-tokens", "12"])
        wall_s = time.perf_counter() - t0
        launches, expect = read_launches(engine.target, engine.draft)
        # pp decodes without a tree: only flash runs on that path
        used = (["flash_attention_lse"] if mode == "pp"
                else list(launches))
        good = len(res) == 3 and all(
            len(r.tokens) == 13 and (r.tokens >= 0).all()
            and (r.tokens < pipedec_pair.TARGET_SMOKE.vocab_size).all()
            for r in res.values())
        good = good and launches == expect and all(launches[k] for k in used)
        ok = ok and good
        emit({"phase": "cli", "mode": mode, "ok": good, "wall_s": wall_s,
              "calls": {"target": dict(engine.target.calls),
                        "draft": dict(engine.draft.calls)
                        if engine.draft is not None else None},
              "launches": launches, "expected_launches": expect,
              "printed": buf.getvalue().strip().splitlines()})

    # the same smoke-size weights on the card and on the CPU
    pcfg = PipeDecConfig(n_stages=4, width=8, branch=4)
    cpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu")) for c, s in
           ((pipedec_pair.TARGET_SMOKE, 0), (pipedec_pair.DRAFT_SMOKE, 1))]
    gpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu").to("cuda"))
           for c, s in ((pipedec_pair.TARGET_SMOKE, 0),
                        (pipedec_pair.DRAFT_SMOKE, 1))]
    prompt = np.random.default_rng(1).integers(0, 512, size=16)
    l_cpu, _ = cpu[0].prefill(prompt[None], cpu[0].init_cache(1, 32))
    l_gpu, _ = gpu[0].prefill(prompt[None], gpu[0].init_cache(1, 32))
    err = float((l_cpu - l_gpu.cpu()).abs().max())
    out_cpu, _ = PipeDecEngine(*cpu, pcfg).generate(prompt, 16)
    out_gpu, _ = PipeDecEngine(*gpu, pcfg).generate(prompt, 16)
    same = bool(np.array_equal(out_cpu, out_gpu))
    good = err <= 1e-4 and same
    emit({"phase": "cli", "check": "card vs CPU, smoke pair, same weights",
          "ok": good, "prefill_logits_max_abs_err": err, "tol": 1e-4,
          "pipedec_tokens_equal": same})
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

    state, failed = {}, []
    for name, phase in (("kernels", phase_kernels), ("serve", phase_serve),
                        ("self-draft", phase_self_draft),
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
    for name, src, replaces in (
            ("flash_attention_lse", "src/repro_torch/csrc/flash_attention_lse.cu",
             "src/repro/kernels/flash.py:102"),
            ("tree_block_attention",
             "src/repro_torch/csrc/tree_block_attention.cu",
             "src/repro/kernels/tree_block.py:54")):
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
