"""Dry run of every (arch x input shape) on the reference's production
meshes: the port of the JAX package's ``repro/launch/dryrun.py``.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
                                      [--out rows.jsonl]
  python -m repro_torch.launch.dryrun --pipeline [--arch A] [--stages 16]
                                      [--width 32]

The reference lowers and compiles each step with XLA on 512 fake host
devices.  The port runs each step once on PyTorch's ``meta`` device at
published width and the shape's full batch and length: weights, caches
and inputs are shapes with no storage (``launch.specs``), so nothing is
allocated and no card is needed.  The pass proves the step runs at that
shape, and ``FlopCounterMode`` counts its products.  The steps are the
reference's: train is the forward and backward of ``make_train_step``'s
loss with remat on (the AdamW update is left out: it is elementwise and
counts no product), prefill is ``make_prefill_step`` (it builds its own
bf16 cache), decode is ``make_serve_step`` on a ``seq_len`` cache, each
with ``specs.window_override`` (4096 keys for the full-attention
families at ``long_500k``).  The decode pass writes at row ``seq_len -
1``: the port's steps take row offsets as host ints, where the
reference's take a traced scalar.  The mesh enters only the byte counts
(``launch.sharding``), so both meshes reuse one pass.  One row per arch x
shape x mesh is printed and appended to ``--out``; any failure makes the
exit code 1, as in the reference.  Several combinations run in worker
processes, one a CPU core (spawned; each pass is one host thread of
dispatch).
What stays with XLA (HLO collective bytes, compiled memory analysis) is
said in ``launch.analysis``.

``--pipeline`` runs one tick of the port's stage ring
(``launch.pipeline.make_pipedec_tick``) on meta: ``--stages`` stages,
a ``--width``-row tree layer entering stage 0 of a ring whose every other
stage holds one in flight, over a 32,768-row cache, as the reference's
``lower_pipeline_tick`` lowers it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import multiprocessing
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as cfg_reg
from repro_torch.launch import analysis, sharding, specs, steps
from repro_torch.launch import pipeline as pl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import trainable
from repro_torch.models import transformer as tf


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _input_bytes(ins: dict, mesh, batch: int) -> int:
    """Per-device bytes of a step's tensor inputs (the cache apart), each
    sharded over the batch where it divides."""
    total = 0
    for key, t in ins.items():
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            continue
        spec = sharding.batch_pspec(mesh, batch, t.dim())
        n = int(np.prod(sharding.shard_shape(tuple(t.shape), spec, mesh)))
        total += n * t.dtype.itemsize
    return total


def count_products(cfg, shape, model, ins: dict) -> tuple:
    """(products, cache) of one pass of the reference's ``shape.kind``
    step over ``model`` and the step inputs ``ins`` (``specs.input_specs``'
    keys) on their device, with ``specs.window_override``: the cache is
    the one the prefill step built (in the weights' dtype), or the decode
    step's input, or None for a train step.  A train step's weights must
    take gradients."""
    wo = specs.window_override(cfg, shape)
    out = {"cache": None}
    if shape.kind == "train":
        def run():
            steps.batch_loss(model, ins, remat=True,
                             window_override=wo).backward()
    elif shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, window_override=wo,
                                       cache_dtype=model.embed.table.dtype)

        def run():
            _, out["cache"] = step(model, ins["tokens"],
                                   prefix_embeds=ins.get("prefix_embeds"),
                                   frames=ins.get("frames"))
    else:
        step = steps.make_serve_step(cfg, window_override=wo)
        out["cache"] = ins["cache"]

        def run():
            step(model, ins["token"], ins["cache"], shape.seq_len - 1,
                 enc_out=ins.get("enc_out"))
    return _counted(run), out["cache"]


def count_step(arch: str, shape_name: str) -> dict:
    """One meta pass of ``arch``'s step at ``shape_name``: {"flops",
    "model", "ins", "cache", "pass_s", "window_override"}."""
    cfg = cfg_reg.get_config(arch)
    shape = specs.SHAPES[shape_name]
    model = specs.param_specs(cfg)
    if shape.kind == "train":
        trainable(model)
    ins = specs.input_specs(cfg, shape)
    t0 = time.perf_counter()
    flops, cache = count_products(cfg, shape, model, ins)
    return {"flops": flops, "model": model, "ins": ins, "cache": cache,
            "pass_s": time.perf_counter() - t0,
            "window_override": specs.window_override(cfg, shape)}


def roofline_row(arch: str, shape_name: str, counted: dict, *,
                 multi_pod: bool = False) -> dict:
    """The row of one counted pass on one production mesh."""
    cfg = cfg_reg.get_config(arch)
    shape = specs.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    leaves = sharding.param_leaves(counted["model"])
    b = shape.global_batch
    param_bytes = sharding.device_bytes(
        leaves, lambda p, s: sharding.param_pspec(p, s, cfg, mesh), mesh)
    opt_bytes = 0
    if shape.kind == "train":   # m and v in fp32, ZeRO-1
        opt_bytes = 2 * sharding.device_bytes(
            leaves, lambda p, s: sharding.zero1_pspec(p, s, cfg, mesh),
            mesh, torch.float32)
    cache_bytes = 0
    if counted["cache"] is not None:
        cache_bytes = sharding.device_bytes(
            sharding.cache_leaves(cfg, counted["cache"],
                                  stacked=shape.kind == "prefill"),
            lambda p, s: sharding.cache_pspec(
                p, s, cfg, mesh, batch=b,
                shard_seq=shape.name == "long_500k"), mesh)
    roof = analysis.roofline(
        arch, shape, mesh, flops=counted["flops"], cfg=cfg,
        param_bytes=param_bytes, opt_bytes=opt_bytes,
        cache_bytes=cache_bytes,
        input_bytes=_input_bytes(counted["ins"], mesh, b),
        window_override=counted["window_override"])
    return roof.row(multi_pod=multi_pod, pass_s=counted["pass_s"])


def lower_pipeline_tick(arch: str, *, n_stages: int = 16,
                        width: int = 32) -> dict:
    """One tick of the port's stage ring on meta at ``arch``'s published
    width: every stage holds a ``width``-row tree layer (stage 0 the one
    entering) over ``max_len`` committed rows, bf16 weights and caches.
    Returns the counted row (no mesh: the ring is one program per
    stage)."""
    cfg = cfg_reg.get_config(arch)
    max_len = 32768
    pcfg = pl.PipelineConfig(n_stages=n_stages, width=width,
                             tree_capacity=width * (n_stages + 4),
                             max_len=max_len)
    model = specs.param_specs(cfg)
    layers, valid = pl.stage_params(model, n_stages)
    meta, dt = specs.META, specs.CACHE_DTYPE
    mkv = pl.split_stages(specs.cache_specs(cfg, 1, max_len), n_stages)
    tcap = pcfg.tree_capacity + width
    tkv = pl.split_stages(tf.cast_cache(
        tf.init_tree_caches(cfg, 1, tcap, device=meta), dt), n_stages)

    def entry(k):
        return {"act": torch.empty((1, width, cfg.d_model), dtype=dt,
                                   device=meta),
                "positions": torch.empty((1, width), dtype=torch.long,
                                         device=meta),
                "mask": torch.empty((1, width, tcap), dtype=torch.bool,
                                    device=meta),
                "model_len": torch.empty((1,), dtype=torch.int32,
                                         device=meta),
                "write_idx": np.array([k * width]), "valid": np.ones(1, bool),
                "version": np.zeros(1, np.int64),
                "lens": np.array([max_len - 1])}

    calls = collections.Counter()
    tick = pl.make_pipedec_tick(cfg, pcfg, calls=calls)
    ring = pl.init_ring(pcfg, 1)
    # fill the ring: n_stages - 1 ticks put one layer in every stage
    # but the first, uncounted
    with torch.no_grad():
        for k in range(n_stages - 1):
            ring, _ = tick(layers, valid, mkv, tkv, ring, entry(k))
        before = calls["stage_layers"]
        t0 = time.perf_counter()
        flops = _counted(lambda: tick(layers, valid, mkv, tkv, ring,
                                      entry(n_stages - 1)))
    return {"arch": arch, "shape": f"pipedec_tick_w{width}",
            "n_stages": n_stages, "width": width, "max_len": max_len,
            "flops": flops, "stage_layers": calls["stage_layers"] - before,
            "pass_s": time.perf_counter() - t0}


def dry_run(arch: str, shape_name: str, meshes: Sequence[bool]):
    """(rows, failures) of one arch x shape: one meta pass, a row per
    mesh (``multi_pod`` flags), failures as (tag, error) pairs."""
    rows, failures = [], []
    try:
        counted = count_step(arch, shape_name)
    except Exception as e:   # record it, run the other combinations
        traceback.print_exc()
        return rows, [(f"{arch} x {shape_name}", repr(e))]
    for mp in meshes:
        tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
        try:
            rows.append(roofline_row(arch, shape_name, counted,
                                     multi_pod=mp))
        except Exception as e:
            traceback.print_exc()
            failures.append((tag, repr(e)))
    return rows, failures


def _dry_run_star(args):
    return dry_run(*args)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry: dry-run one combination, or ``--all`` of them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(specs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="count one tick of the stage ring instead")
    ap.add_argument("--stages", type=int, default=16)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.pipeline:
        row = lower_pipeline_tick(args.arch or "pipedec-target",
                                  n_stages=args.stages, width=args.width)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        return 0

    archs = (cfg_reg.ARCH_IDS if (args.all or not args.arch)
             else [args.arch])
    shapes = (list(specs.SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # shape-major: the train passes, the longest, go to the workers first
    combos = [(a, s, meshes) for s in shapes for a in archs]
    rows, failures = [], []
    jobs = min(len(combos), os.cpu_count() or 1)
    with contextlib.ExitStack() as stack:
        if jobs > 1:
            pool = stack.enter_context(
                multiprocessing.get_context("spawn").Pool(jobs))
            results = pool.imap(_dry_run_star, combos)
        else:
            results = map(_dry_run_star, combos)
        for got, bad in results:
            failures += bad
            for row in got:
                rows.append(row)
                print(f"[dryrun] {row['arch']} x {row['shape']} x "
                      f"{row['mesh']}: flops={row['flops']:.3e} "
                      f"mem/device={row['per_device_mem']:.3e} B "
                      f"-> {row['bottleneck']}-bound; "
                      f"useful={row['useful_ratio']:.2f} "
                      f"({row['pass_s']:.2f} s)", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"\n[dryrun] {len(rows)} ok, {len(failures)} failed")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
