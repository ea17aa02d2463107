"""Run one cell of the port's benchmark once (see ``specbench/README.md``).

    python3 specbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from specbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
