"""The benchmark's CPU tests run from the repository root:
``python3 -m pytest -q specbench/tests``.  The program is imported from
``src`` as the harness imports it."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
