"""The check's control on the card, at a cell's own size: for each seed, one
run of the cell (untraced), then over the run's sample the program's
compared numbers and the control's (the reference with TF32 products in the
program's place), each judged against the configuration's limits.  The
benchmark's own runs never run this.  One JSON line per seed:

    python3 specbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from specbench.lib import bench, check, serve  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    c = bench.cell(bench.load(), args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = serve.run(c.cfg, c.mix, seed, args.seconds, False, device,
                        time.perf_counter())
        t = time.perf_counter()
        out = check.control(run, seed, device)
        print(json.dumps({"workload": c.name, "seed": seed, **out,
                          "reference_s": time.perf_counter() - t}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
