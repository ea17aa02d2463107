#!/usr/bin/env python
"""Where the flash kernel's time goes over long key spans, from stamps.

Builds a traced copy of a ``flash_attention_lse.cu`` source under
``build/flash_trace/`` (each CTA's thread 0 writes the card's global
nanosecond timer, ``%globaltimer``, at fixed points of the kernel into a
device array; the source file itself is not changed), runs it on the card
at the long spans and prints one JSON line per case:

* ``long_500k window``: q [1,40,1,128] at row 524,287 over K/V
  [1,8,524288,128] with a 4096-key window (Qwen2.5-32B's widths);
* ``long_500k all rows``: the same without the window;
* ``decode_32k span``: q [8,40,1,128] over K/V [8,8,32768,128], rows of
  32,768 keys and shorter (``DECODE_32K_KV_LEN``).

Three main-path shapes of ``chip_smoke.py`` phase 2 come first (the
target's tree-verify past half, Gemma's decode, RecurrentGemma's windowed
decode), so a variant's cost there shows beside its long spans.  Each
line gives the kernel's time by CUDA events (median of 9 launches,
traced build), the CTAs launched, those that found no chunk of their own
(``empty``), and from the stamps: the chunk phase (first CTA start to the
last chunk's end), the merge tail (the last chunk's end to the kernel's
last stamp) and the longest single merge.  ``--layout`` names the trace
points of the source: ``chunked`` (one merge of every chunk by the last
CTA of a query tile, the kernel before the group plan) or ``grouped``
(chunk partials merged per group of chunks, then the group partials).

    PYTHONPATH=src python scripts/flash_trace.py --source DIR/flash_attention_lse.cu --layout chunked
    PYTHONPATH=src python scripts/flash_trace.py --layout grouped

The card's name and power limit are printed first; ``--out`` also writes
the lines to a file.  ``--set kWaves=1`` (any ``constexpr int`` of the
source) builds the traced copy with another value of that constant, to
compare plans in one run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DECODE_32K_KV_LEN = (32768, 32768, 30720, 28000, 24576, 20000, 16384, 8192)
# stamps per CTA: start, exit, chunks computed, merges done, ns in merges,
# end of the last merge, the exit's kind, end of the last chunk; then ns
# in the tile loops, in the hand-overs and partial stores, and in the
# fences and counters (``grouped`` only)
WORDS = 12
MAX_CTAS = 1 << 17

HEADER = r"""
__device__ unsigned long long trace_buf[%d];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long* trace_rec() {
  const long long cta = blockIdx.x + (long long)gridDim.x *
      (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  return trace_buf + %d * cta;
}
extern "C" int flash_trace_read(void* dst, long long bytes) {
  return (int)cudaMemcpyFromSymbol(dst, trace_buf, bytes);
}
extern "C" int flash_trace_clear() {
  void* p;
  cudaError_t e = cudaGetSymbolAddress(&p, trace_buf);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(trace_buf));
}
""" % (WORDS * MAX_CTAS, WORDS)

START = ("  const unsigned long long trace_t0 = trace_now();\n"
         "  unsigned long long trace_m = 0, trace_last = 0, trace_ms = 0;\n"
         "  unsigned long long trace_cend = 0, trace_loop = 0, trace_hand = 0;\n"
         "  unsigned long long trace_atom = 0, trace_cs = 0;\n"
         "  int trace_chunks = 0, trace_merges = 0;\n")


def _exit(kind: str) -> str:
    """Thread 0 records the CTA's start, this exit and its counts."""
    return ("  if (threadIdx.x == 0) { unsigned long long* r = trace_rec();"
            " r[0] = trace_t0; r[1] = trace_now(); r[2] = trace_chunks;"
            f" r[3] = trace_merges; r[4] = trace_m; r[5] = trace_last;"
            f" r[6] = {kind}; r[7] = trace_cend; r[8] = trace_loop;"
            " r[9] = trace_hand; r[10] = trace_atom; }\n")


MERGE_IN = "  trace_ms = trace_now();\n"
MERGE_OUT = ("  trace_m += trace_now() - trace_ms; trace_last = trace_now();"
             " ++trace_merges;\n")
CHUNK = "  ++trace_chunks; trace_cend = trace_now();\n"

# (text in the source, text put before it) in order; every anchor must be
# found exactly once
LAYOUTS = {
    "chunked": [
        ("namespace {\n", HEADER),
        ("  const int C = chunk_keys(HD);\n", START),
        ("  if (slot >= nchunks) return;", "  if (slot >= nchunks) {\n"
         + _exit(0) + "  }\n"),
        ("  // element (row i, column 8 dt + 2 tq + e) is acc[dt][2 i + e]\n",
         CHUNK),
        ("  if (!last) return;\n", "  if (!last) {\n" + _exit(1) + "  }\n"),
        ("  const float* base = work + grp * gridDim.x * pstride;\n",
         MERGE_IN),
        ("  if (tid == 0) counters[grp] = 0;       // ready for the next call\n",
         MERGE_OUT + _exit(2)),
    ],
    "grouped": [
        ("namespace {\n", HEADER),
        ("  const int bg = blockIdx.z;             // b * KV + g\n", START),
        ("  if ((int)blockIdx.x >= nchunks) return;",
         "  if ((int)blockIdx.x >= nchunks) {\n" + _exit(0) + "  }\n"),
        ("    if (!first) __syncthreads();", "    trace_cs = trace_now();\n"),
        ("    if (!prefetch) cp_async_wait<0>();\n",
         "    trace_loop += trace_now() - trace_cs; trace_cs = trace_now();\n"),
        ("  };\n\n  // element (row i, column 8 dt + 2 tq + e)", CHUNK),
        ("    const int ga = (c_lo + slot) / G;\n",
         "    trace_hand += trace_now() - trace_cs; trace_cs = trace_now();\n"),
        ("    if (!last) return;\n    __threadfence();\n    const int g_lo",
         "    trace_atom += trace_now() - trace_cs;\n"),
        ("    if constexpr (kLong) {\n      merge_call(cparts", MERGE_IN),
        ("    if (one) return;\n", MERGE_OUT),
        ("    merge_call(gparts", MERGE_IN),
        ("  };\n\n  if constexpr (kLong) {", MERGE_OUT),
        # the CTA's exit after its last slot
        ("}\n\n// The CTAs one instance keeps resident", _exit(1)),
    ],
}


def patched(source: Path, layout: str, sets=()) -> str:
    text = source.read_text()
    for item in sets:
        name, value = item.split("=")
        pat = re.compile(rf"constexpr int {name} = \d+;")
        if len(pat.findall(text)) != 1:
            raise SystemExit(f"no single constexpr int {name} in {source}")
        text = pat.sub(f"constexpr int {name} = {int(value)};", text)
    for anchor, before in LAYOUTS[layout]:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {source}: {anchor!r}")
        text = text.replace(anchor, before + anchor)
    # an early return past an inserted block is dead but harmless
    return text


def build(source: Path, layout: str, sets=()) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    out = ROOT / "build" / "flash_trace"
    out.mkdir(parents=True, exist_ok=True)
    tag = "_".join([layout, *sets]).replace("=", "")
    cu = out / f"flash_{tag}.cu"
    cu.write_text(patched(source, layout, sets))
    lib = out / f"flash_{tag}.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(source.parent), "-I",
           str(kb.CSRC), "-o", str(lib), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    print("\n".join(x for x in (res.stdout + res.stderr).splitlines()
                    if "registers" in x or "spill" in x), flush=True)
    so = ctypes.CDLL(str(lib))
    so.flash_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return so


def cases(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(40)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def at(*rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)
    # main-path shapes of chip_smoke.py phase 2, one chunk group each
    yield "main tree-past target B=1", dict(
        q=rnd(1, 64, 8, 128), k=rnd(1, 8, 512, 128), v=rnd(1, 8, 512, 128),
        kv_len=at(200), qpos=(199 + torch.arange(8, device=dev) // 2)[None]
        .to(torch.int32), window=0)
    yield "main decode gemma hd256", dict(
        q=rnd(1, 16, 1, 256), k=rnd(1, 16, 512, 256),
        v=rnd(1, 16, 512, 256), kv_len=at(200), qpos=at(199)[None],
        window=0)
    yield "main window 2048 decode recurrentgemma", dict(
        q=rnd(1, 16, 1, 256), k=rnd(1, 1, 4096, 256), v=rnd(1, 1, 4096, 256),
        kv_len=at(3000), qpos=at(2999)[None], window=2048)
    rows = 524288
    k, v = rnd(1, 8, rows, 128), rnd(1, 8, rows, 128)
    q = rnd(1, 40, 1, 128)
    kvl = torch.tensor([rows], dtype=torch.int32, device=dev)
    qp = torch.tensor([[rows - 1]], dtype=torch.int32, device=dev)
    yield "long_500k window", dict(q=q, k=k, v=v, kv_len=kvl, qpos=qp,
                                   window=4096)
    yield "long_500k all rows", dict(q=q, k=k, v=v, kv_len=kvl, qpos=qp,
                                     window=0)
    del k, v
    k, v = rnd(8, 8, 32768, 128), rnd(8, 8, 32768, 128)
    kvl = torch.tensor(DECODE_32K_KV_LEN, dtype=torch.int32, device=dev)
    yield "decode_32k span", dict(q=rnd(8, 40, 1, 128), k=k, v=v,
                                  kv_len=kvl, qpos=(kvl - 1)[:, None],
                                  window=0)


def run_case(torch, so, layout, a):
    from repro_torch.kernels import flash
    q, k, v = a["q"], a["k"], a["v"]
    b, h, n, hd = q.shape
    kvh, length = k.shape[1], k.shape[2]
    rep = h // kvh
    bq = flash.queries_per_cta(rep)
    tiles = b * kvh * -(-n // bq)
    chunks = -(-length // flash.chunk_keys(hd))
    # enough for either layout: 64 rows a chunk partial (the earlier
    # layout), and a counter per chunk
    work = torch.empty(tiles * chunks * flash.ROWS * (hd + 2),
                       device=q.device)
    count = torch.zeros(tiles * (chunks + 1), dtype=torch.int32,
                        device=q.device)
    o = torch.empty_like(q)
    m = torch.empty(b, h, n, device=q.device)
    l = torch.empty_like(m)
    fn = so.flash_attention_lse_launch
    fn.argtypes = flash._ARGTYPES
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), v.data_ptr(),
                 *k.stride()[:3], None, None, 0, 0, 0,
                 a["kv_len"].data_ptr(), a["qpos"].data_ptr(),
                 o.data_ptr(), m.data_ptr(), l.data_ptr(), work.data_ptr(),
                 count.data_ptr(), b, h, kvh, n, length, hd, bq, 0,
                 a["window"], hd ** -0.5, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    launch()
    torch.cuda.synchronize()
    want = flash.flash_attention_lse_plain(q, k, v, a["kv_len"], a["qpos"],
                                           scale=hd ** -0.5,
                                           window=a["window"])
    err = float((o - want[0]).abs().max())
    times = []
    for _ in range(9):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    if so.flash_trace_clear():
        raise RuntimeError("trace clear failed")
    launch()
    torch.cuda.synchronize()
    buf = np.zeros(WORDS * MAX_CTAS, dtype=np.uint64)
    if so.flash_trace_read(buf.ctypes.data, buf.nbytes):
        raise RuntimeError("trace read failed")
    rec = buf.reshape(MAX_CTAS, WORDS)
    rec = rec[rec[:, 0] != 0].astype(np.int64)
    t0 = int(rec[:, 0].min())
    work_rows = rec[rec[:, 2] > 0]
    empty = rec[rec[:, 2] == 0]
    last_chunk = int(work_rows[:, 7].max())
    end = int(rec[:, 1].max())
    merging = work_rows[work_rows[:, 3] > 0]
    life = float((work_rows[:, 1] - work_rows[:, 0]).sum())
    shares = {name: float(work_rows[:, col].sum()) / life for name, col in
              (("tile_loops", 8), ("handover_and_partial", 9),
               ("fence_and_counter", 10), ("merges", 4))}
    return {"traced_kernel_ms": statistics.median(times),
            "max_abs_err_vs_plain": err,
            "ctas": int(len(rec)), "empty_ctas": int(len(empty)),
            "chunks_computed": int(work_rows[:, 2].sum()),
            "merges": int(merging[:, 3].sum()),
            "span_ms": (end - t0) / 1e6,
            "chunk_phase_ms": (last_chunk - t0) / 1e6,
            "merge_tail_ms": (end - last_chunk) / 1e6,
            "longest_merge_ms": (int(merging[:, 4].max()) / 1e6
                                 if len(merging) else 0.0),
            "last_work_cta_start_ms": (int(work_rows[:, 0].max()) - t0)
            / 1e6,
            "empty_cta_end_ms": ((int(empty[:, 1].max()) - t0) / 1e6
                                 if len(empty) else 0.0),
            "share_of_cta_time": shares}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", type=Path,
                   default=ROOT / "src/repro_torch/csrc/flash_attention_lse.cu")
    p.add_argument("--layout", choices=sorted(LAYOUTS), default="grouped")
    p.add_argument("--set", action="append", default=[], dest="sets")
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_trace: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    so = build(args.source, args.layout, args.sets)
    dev = torch.device("cuda")
    lines = []
    for name, a in cases(torch, dev):
        line = {"case": name, "layout": args.layout, "set": args.sets,
                "source": str(args.source), "card": card,
                **run_case(torch, so, args.layout, a)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
