"""Where a PipeDec timestep's time goes on the card.

Builds the paper's pair at published widths (the target cut to 8 layers,
one per stage of the 8-stage pipeline, as in ``chip_smoke.py``; seeded
random weights), runs one request through ``PipeDecEngine`` and, after
WARMUP timesteps, times STEPS timesteps twice: once plainly (host clock
around work that ends in a synchronise) and once under ``torch.profiler``.
Prints JSON lines:
wall time per timestep, the card's busy time per timestep (sum of kernel
and copy durations from the trace), its idle share and device time by
kernel name; writes the Chrome trace to ``--trace``.  The idle share is
taken against the plain wall time, since the profiler itself slows the
host; the share against the profiled wall time is printed beside it.
``--quant int8`` profiles the int8 serving path (both bundles quantized).
A ``families`` line sums the device time and launches per timestep of the
port's kernels by kernel (tree, flash, dequant-matmul) and of the eager
``combine_lse`` merge (the kernels launched under a ``combine_lse``
profiler span, which wraps the function for the profiled window only).
The script runs as a file too (``python src/repro_torch/launch/
profile_serve.py`` with ``PYTHONPATH`` on another checkout's ``src``), so
an earlier commit's code is profiled with the same counts.
``--mode pipedec-db`` profiles SpecPipe-DB timesteps instead: DB_SLOTS
requests admitted at once on the local executor (``--paged`` for the
block-paged arena, whose tree verify runs the paged kernels), so every
profiled timestep runs at occupancy DB_SLOTS.  ``--executor sharded``
runs them on the 8-stage ring instead (``ShardedPipelineExecutor``, one
flush per timestep), and ``--overlap`` on the overlapped ring
(``OverlappedShardedExecutor``, one tick per timestep, prefill in the
ring; its warm-up also covers the requests' joining ticks).
``--executor async`` runs them on the free-running stage actors
(``AsyncPipelineExecutor``, dense arena only) and adds an ``actors`` line:
each stage actor's busy and idle seconds of its host thread per timestep
over the plainly timed window, its largest inbox depth, and the draft's
largest lead.  ``--quant int8`` composes with every executor.
``--target-arch`` and ``--draft-arch`` profile another pair of the
registry at published widths (the target cut to 8 layers, the draft given
the target's vocabulary), e.g. ``--target-arch gemma-7b --draft-arch
gemma-7b``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--quant int8] [--mode pipedec-db [--paged]
      [--executor sharded [--overlap] | --executor async]]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs as cfg_reg
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, tree_block
from repro_torch.models import transformer as tf
from repro_torch.serving import (AsyncPipelineExecutor, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine)

TARGET_LAYERS, STAGES, PROMPT_LEN, WARMUP, STEPS = 8, 8, 64, 8, 16
DB_SLOTS, DB_PROMPT_LENS, MAX_LEN = 3, (64, 96, 80), 512
# kernel name fragments of the port's kernels, by family
FAMILIES = {"tree": "tree_block_attention_kernel",
            "flash": "flash_attention_lse_kernel",
            "dequant_matmul": "dequant_matmul_kernel"}
SPAN = "combine_lse"


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def _combine_lse_span():
    """Wrap ``combine_lse`` (where the ops and tree_block modules reach
    it) in a profiler span while the block runs."""
    saved = [(m, m.combine_lse) for m in (ops, tree_block)
             if hasattr(m, "combine_lse")]

    def traced(parts, _fn=saved[0][1]):
        with record_function(SPAN):
            return _fn(parts)
    for m, _ in saved:
        m.combine_lse = traced
    try:
        yield
    finally:
        for m, fn in saved:
            m.combine_lse = fn


def _under(ev):
    """(device us, kernels) launched under a CPU event and its children."""
    us = sum(k.duration for k in ev.kernels)
    count = len(ev.kernels)
    for child in ev.cpu_children:
        cu, cn = _under(child)
        us, count = us + cu, count + cn
    return us, count


def main(argv=None) -> None:
    """Profile STEPS PipeDec (or SpecPipe-DB) timesteps at full width."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.profile_serve")
    ap.add_argument("--trace", default="build/profile/profile_serve_trace.json")
    ap.add_argument("--quant", choices=["none", "int8"], default="none")
    ap.add_argument("--mode", choices=["pipedec", "pipedec-db"],
                    default="pipedec")
    ap.add_argument("--paged", action="store_true",
                    help="pipedec-db: the block-paged arena (16-row pages)")
    ap.add_argument("--executor", choices=["local", "sharded", "async"],
                    default="local",
                    help="pipedec-db: the local fused executor, the "
                         "8-stage ring or its free-running stage actors")
    ap.add_argument("--overlap", action="store_true",
                    help="--executor sharded: one ring tick per timestep")
    ap.add_argument("--target-arch", default="pipedec-target",
                    help="the target's architecture at published width, "
                         f"cut to {TARGET_LAYERS} layers")
    ap.add_argument("--draft-arch", default="pipedec-draft",
                    help="the draft's architecture at published width, "
                         "with the target's vocabulary")
    args = ap.parse_args(argv)
    if (args.paged or args.executor != "local") and \
            args.mode != "pipedec-db":
        ap.error("--paged and --executor need --mode pipedec-db")
    if args.overlap and args.executor != "sharded":
        ap.error("--overlap needs --executor sharded")
    if args.paged and args.executor == "async":
        ap.error("--executor async has no paged arena")

    dev = resolve_device("cuda")
    tcfg = cfg_reg.get_config(args.target_arch)
    tcfg = dataclasses.replace(tcfg, num_layers=min(TARGET_LAYERS,
                                                    tcfg.num_layers))
    dcfg = dataclasses.replace(cfg_reg.get_config(args.draft_arch),
                               vocab_size=tcfg.vocab_size)
    target = ModelBundle(tf.init_model(tcfg, seed=0, device=dev))
    if args.quant == "int8":    # the fp32 projections are freed here
        target = target.quantize()
    draft = ModelBundle(tf.init_model(dcfg, seed=1, device=dev))
    if args.quant == "int8":
        draft = draft.quantize()
    pcfg = PipeDecConfig(n_stages=STAGES, width=8, branch=4)
    rng = np.random.default_rng(0)
    n_steps = WARMUP + 2 * STEPS
    if args.mode == "pipedec":
        eng = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
        st = eng.init_state(rng.integers(0, tcfg.vocab_size,
                                         size=PROMPT_LEN),
                            max_new_tokens=n_steps,
                            max_timesteps=n_steps + 1)

        def step():
            eng.step(st)
    else:
        kw = dict(slots=DB_SLOTS, max_len=MAX_LEN,
                  tree_capacity=pcfg.tree_buffer_capacity,
                  capacity=pcfg.capacity, paged=args.paged)
        if args.executor == "async":
            ex = AsyncPipelineExecutor(target, draft, n_stages=STAGES, **kw)
        elif args.executor == "sharded":
            cls = (OverlappedShardedExecutor if args.overlap
                   else ShardedPipelineExecutor)
            ex = cls(target, draft, n_stages=STAGES, **kw)
        else:
            ex = LocalFusedExecutor(target, draft, **kw)
        db = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                              max_slots=DB_SLOTS, executor=ex)
        # budgets no request reaches within the window: occupancy stays
        # DB_SLOTS in every profiled timestep
        for uid, n in enumerate(DB_PROMPT_LENS):
            db.submit(Request(uid, rng.integers(0, tcfg.vocab_size, size=n),
                              n_steps))
        timesteps = db.steps()
        step = functools.partial(next, timesteps)
    # the overlapped ring admits through its prefill lane: each request
    # joins after its chunks crossed the STAGES stages
    for _ in range(WARMUP + (STAGES + 2 if args.overlap else 0)):
        step()
    torch.cuda.synchronize()

    actors = args.executor == "async"
    before = ex.counters() if actors else None
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    after = ex.counters() if actors else None

    with _combine_lse_span(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # the span's device-side annotation is no kernel
        if ev.device_type == DeviceType.CUDA and ev.name != SPAN:
            acc = by_name[ev.name]
            acc[0] += ev.time_range.elapsed_us()
            acc[1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / STEPS
    occupancy = (1 if args.mode == "pipedec"
                 else db.stats.occupancy[-1])
    _emit({"profile": "timestep", "device": torch.cuda.get_device_name(0),
           "mode": args.mode, "paged": args.paged, "occupancy": occupancy,
           "executor": args.executor, "overlap": args.overlap,
           "quant": args.quant, "target": tcfg.name, "draft": dcfg.name,
           "target_layers": tcfg.num_layers,
           "stages": STAGES,
           "steps": STEPS, "wall_ms": wall_ms,
           "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "idle_share_profiled": 1.0 - busy_ms / prof_wall_ms,
           "kernel_launches_per_step": sum(v[1] for v in by_name.values())
           / STEPS})
    fam = {}
    for key, frag in FAMILIES.items():
        hit = [v for name, v in by_name.items() if frag in name]
        fam[key + "_ms_per_step"] = sum(v[0] for v in hit) / 1e3 / STEPS
        fam[key + "_launches_per_step"] = sum(v[1] for v in hit) / STEPS
    spans = [_under(ev) for ev in prof.events()
             if ev.name == SPAN and ev.device_type == DeviceType.CPU]
    fam["combine_lse_calls_per_step"] = len(spans) / STEPS
    fam["combine_lse_ms_per_step"] = sum(u for u, _ in spans) / 1e3 / STEPS
    fam["combine_lse_launches_per_step"] = sum(c for _, c in spans) / STEPS
    _emit({"profile": "families", **fam})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, count) in top:
        _emit({"profile": "kernel", "name": name[:120],
               "ms_per_step": us / 1e3 / STEPS,
               "calls_per_step": count / STEPS,
               "us_per_call": us / count})
    if actors:
        _emit({"profile": "actors", "steps": STEPS, "stages": [
            {"stage": k,
             "busy_ms_per_step": 1e3 * (a["busy_s"] - b["busy_s"]) / STEPS,
             "idle_ms_per_step": 1e3 * (a["idle_s"] - b["idle_s"]) / STEPS,
             "max_depth": a["max_depth"]}
            for k, (b, a) in enumerate(zip(before["stages"],
                                           after["stages"]))],
            "max_draft_lead": after["max_draft_lead"]})
        ex.shutdown()
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
