"""The command: run one cell once and print its result line.

    python3 specbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiled run of timesteps inside the window).  Either
way the finished requests are checked against the plain reference after the
window, and the compared numbers end standard error and the result line.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from specbench.lib import bench, check, serve

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def result(c: bench.Cell, run, seed: int, traced: bool, device) -> Dict:
    """The result line's object for a finished run."""
    import torch
    verdict = check.check(run, seed, device)
    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        value = bench.reader(m).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.chips,
           "memory_peak_bytes": int(max(run.peak_setup_bytes,
                                        run.peak_window_bytes))}
    active = [u for u, ts in run.stamps.items()
              if any(run.in_window(t) for t in ts)
              or run.in_window(run.sent.get(u, -1e300))]
    out = {"correct": verdict["correct"], "attempted": len(active),
           "failed": sum(1 for u in active if not run.stamps[u]),
           "metrics": metrics, "device": dev}
    if traced and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["compared"] = verdict["compared"]
    return out, verdict


def summary(run, verdict: Dict) -> Dict:
    """What the run did, for the reader of standard error (with the time to
    first token's 80th and 90th percentiles, in an untraced run too, and
    the widest logit distance of the check)."""
    t = run.trace or {}
    return {"setup_parts_s": run.setup_parts, "window_s": run.window_s,
            "ttft_p80_ms": serve.ttft_ms(run, 80),
            "ttft_p90_ms": serve.ttft_ms(run, 90),
            "logit_dist_max": verdict["max_dist"],
            "timesteps": len(run.steps),
            "finished": len(run.finished),
            "sent_in_window": sum(1 for s in run.sent.values()
                                  if run.in_window(s)),
            "traced_timesteps": t.get("timesteps"),
            "attn_calls": run.attn_calls,
            "paged_kernels": t.get("paged_kernels")}


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = bench.cell(bench.load(), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{c.name} needs {c.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = serve.run(c.cfg, c.mix, args.seed, args.seconds, bool(args.trace),
                    device, t_start)
    out, verdict = result(c, run, args.seed, bool(args.trace), device)
    print(json.dumps(summary(run, verdict)), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print("loaded modules of the JAX stack or package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
