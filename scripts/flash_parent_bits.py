#!/usr/bin/env python
"""The flash kernel against an earlier build of itself, bit for bit.

Builds ``flash_attention_lse.cu`` of another checkout (``--parent``, the
directory that holds it and its ``attn_common.cuh``) under
``build/flash_parent_bits/``, and runs it beside the kernel of this
checkout (``repro_torch.kernels.flash`` and ``paged``) on the same inputs:
the main path's flash cases of ``chip_smoke.py`` phase 2 (fp32, int8,
head_dim 256, RecurrentGemma's 2048-key window, Whisper's encoder and
cross-attention, the paged bucket-3 cases) and long_500k's windowed decode
at row 524,287, whose 4096 keys are one group.  Each line says whether o,
m and l are bit-equal and gives both kernels' device time (CUDA-graph
replays of 10 launches, median of 21, in the order earlier, this, this,
earlier).  A case whose span crosses a group of 4096 keys (the windowed
tree verify's past half at 4224 committed rows) is reported too, marked
``one_group: false``: its merge has two levels, so its bits may differ.

    git archive <parent> src/repro_torch/csrc | tar -x -C build/parent
    PYTHONPATH=src python scripts/flash_parent_bits.py --parent build/parent/src/repro_torch/csrc

Exit status 1 when a one-group case is not bit-equal.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAGE = 16
# (name, B, H, KV, n, hd, L, kv_len, causal, window, int8, paged, q0)
CASES = (
    ("flash/tree-past target B=1", 1, 64, 8, 8, 128, 512, [200], False, 0,
     False, False, None),
    ("flash int8/tree-past target B=1", 1, 64, 8, 8, 128, 512, [200], False,
     0, True, False, None),
    ("flash/tree-past target B=4", 4, 64, 8, 8, 128, 512, [200, 37, 512, 0],
     False, 0, False, False, None),
    ("flash/decode target", 1, 64, 8, 1, 128, 512, [200], False, 0, False,
     False, None),
    ("flash/prefill causal S=128", 1, 64, 8, 128, 128, 128, [128], True, 0,
     False, False, None),
    ("flash/window 64", 1, 64, 8, 8, 128, 512, [300], False, 64, False,
     False, None),
    ("flash/tree-past draft B=1", 1, 32, 8, 8, 64, 512, [200], False, 0,
     False, False, None),
    ("flash hd256/tree-past gemma B=1", 1, 16, 16, 8, 256, 512, [200],
     False, 0, False, False, None),
    ("flash int8 hd256/tree-past gemma B=1", 1, 16, 16, 8, 256, 512, [200],
     False, 0, True, False, None),
    ("flash hd256 window/decode recurrentgemma L=4096", 1, 16, 1, 1, 256,
     4096, [3000], False, 2048, False, False, None),
    ("flash hd256 window/prefill recurrentgemma n=64", 1, 16, 1, 64, 256,
     2112, [2112], True, 2048, False, False, [2048]),
    ("flash/encoder whisper T=1500", 1, 8, 8, 1500, 64, 1500, [1500], False,
     0, False, False, None),
    ("paged flash/tree-past target B=3", 3, 64, 8, 8, 128, 512,
     [90, 200, 130], False, 0, False, True, None),
    ("paged flash int8/tree-past target B=3", 3, 64, 8, 8, 128, 512,
     [90, 200, 130], False, 0, True, True, None),
    ("paged flash hd256/tree-past gemma B=3", 3, 16, 16, 8, 256, 512,
     [90, 200, 130], False, 0, False, True, None),
    ("paged flash int8 hd256/tree-past gemma B=3", 3, 16, 16, 8, 256, 512,
     [90, 200, 130], False, 0, True, True, None),
    ("flash/long_500k decode window 4096 at row 524,287", 1, 40, 8, 1, 128,
     524288, [524288], False, 4096, False, False, None),
    ("flash/windowed tree-verify past half, 4224 committed", 1, 40, 8, 8,
     128, 4352, [4224], False, 4096, False, False, None),
)


def _build(csrc: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    out = ROOT / "build" / "flash_parent_bits"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "flash_attention_lse_parent.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
           str(csrc / "flash_attention_lse.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    print("\n".join(x for x in (res.stdout + res.stderr).splitlines()
                    if "registers" in x or "spill" in x or "Compiling" in x),
          flush=True)
    return ctypes.CDLL(str(lib))


def _graph_ms(torch, fn, per=10, reps=21):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per)
    return statistics.median(times)


def run_case(torch, so, case):
    from repro_torch.kernels import flash, paged
    from repro_torch.kernels.quant import quantize_rows
    from repro_torch.models import paging
    (name, b, h, kvh, n, hd, length, kv_len, causal, window, int8, is_paged,
     q0) = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(len(name))
    q = torch.randn(b, n, h, hd, device=dev, generator=gen).transpose(1, 2)
    kv = {}
    for part in ("k", "v"):
        x = torch.randn(b, length, kvh, hd, device=dev, generator=gen)
        if int8:
            x, kv[part + "_scale"] = quantize_rows(x)
        kv[part] = x
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    if causal:
        qpos = torch.arange(n, device=dev).expand(b, n)
        if q0 is not None:
            qpos = qpos + torch.tensor(q0, device=dev)[:, None]
    else:
        qpos = (kvl.long() - 1).clamp_min(0)[:, None] + torch.arange(
            n, device=dev) // 2
    qpos = qpos.to(torch.int32).contiguous()
    rep = h // kvh
    bq = flash.queries_per_cta(rep)
    if is_paged:
        mb = length // PAGE
        ids = 1 + torch.randperm(b * mb, generator=torch.Generator()
                                 .manual_seed(1))
        table = ids.view(b, mb).to(torch.int32).to(dev)
        views = {k: paging.pool_view(paging.make_paged(x, table, PAGE).pages,
                                     PAGE) for k, x in kv.items()}
        sc = {k: views[k] for k in ("k_scale", "v_scale") if int8}

        def new():
            return paged.paged_flash_attention_lse(
                q, views["k"], views["v"], table, kvl, qpos, causal=causal,
                window=window, **sc)
        kv_args = [views["k"].data_ptr(), views["v"].data_ptr(),
                   *views["k"].stride()[:3],
                   *flash.scale_args(sc.get("k_scale"), sc.get("v_scale")),
                   table.data_ptr(), mb, PAGE]
        fn = so.paged_flash_attention_lse_launch
        fn.argtypes = paged._FLASH_ARGTYPES
    else:
        views = {k: x.transpose(1, 2) for k, x in kv.items()}
        sc = {k: views[k] for k in ("k_scale", "v_scale") if int8}

        def new():
            return flash.flash_attention_lse(q, views["k"], views["v"], kvl,
                                             qpos, causal=causal,
                                             window=window, **sc)
        kv_args = [views["k"].data_ptr(), views["v"].data_ptr(),
                   *views["k"].stride()[:3],
                   *flash.scale_args(sc.get("k_scale"), sc.get("v_scale"))]
        fn = so.flash_attention_lse_launch
        fn.argtypes = flash._ARGTYPES
    # the earlier kernel's scratch: 64-row partials for every chunk of
    # every tile, one counter a tile
    tiles = b * kvh * -(-n // bq)
    chunks = max(1, -(-length // flash.chunk_keys(hd)))
    work = torch.empty(max(1, tiles * chunks * 64 * (hd + 2)), device=dev)
    count = torch.zeros(tiles, dtype=torch.int32, device=dev)
    o = torch.empty(b, h, n, hd, device=dev)
    m = torch.empty(b, h, n, device=dev)
    l = torch.empty_like(m)
    tail = ([b, h, kvh, n] + ([] if is_paged else [length])
            + [hd, bq, int(causal), window, hd ** -0.5])

    def old():
        err = fn(q.data_ptr(), *q.stride()[:3], *kv_args, kvl.data_ptr(),
                 qpos.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
                 work.data_ptr(), count.data_ptr(), *tail,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: earlier kernel cudaError {err}")
        return o, m, l
    want = [x.clone() for x in old()]
    got = new()
    torch.cuda.synchronize()
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    diff = float((got[0] - want[0]).abs().max())
    g = flash.group_chunks(hd, int8)
    plans = flash.chunk_plan(hd, length, kv_len, qpos.tolist(), n, rep,
                             causal=causal, window=window)
    one_group = all(lo // g == (hi - 1) // g for row in plans
                    for lo, hi in row)
    t = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        t[which].append(_graph_ms(torch, old if which == "earlier" else new))
    return {"case": name, "one_group": one_group,
            "bit_equal": dict(zip("oml", equal)), "max_abs_diff_o": diff,
            "earlier_ms": statistics.mean(t["earlier"]),
            "this_ms": statistics.mean(t["this"]),
            "ms_each": t}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_parent_bits: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    so = _build(args.parent)
    lines, bad = [], []
    for case in CASES:
        line = run_case(torch, so, case)
        line["card"] = card
        print(json.dumps(line), flush=True)
        lines.append(line)
        if line["one_group"] and not all(line["bit_equal"].values()):
            bad.append(line["case"])
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(json.dumps({"one_group_cases_bit_equal": not bad, "bad": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
