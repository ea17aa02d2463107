"""The port's ``launch.sharded_check`` on the CPU, each run in a process of
its own: every executor's tokens against the single-request engine's,
with the overlapped, async and int8 legs and the scenarios, and a run
whose reference is broken on purpose, which must fail loudly."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

# a reference that is off by one token: every executor disagrees with it
_BROKEN = """
import sys
from repro_torch.core import pipedec
from repro_torch.launch import sharded_check
real = pipedec.PipeDecEngine.generate
def generate(self, *a, **k):
    tokens, stats = real(self, *a, **k)
    tokens = tokens.copy()
    tokens[-1] += 1
    return tokens, stats
pipedec.PipeDecEngine.generate = generate
sys.exit(sharded_check.main(sys.argv[1:]))
"""


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args, "--device", "cpu"],
                          capture_output=True, text=True, env=env,
                          timeout=TIMEOUT_S, cwd=ROOT)


@pytest.mark.parametrize("flags", [
    ("--overlap", "--async", "--quant"),
    ("--overlap", "--paged")])
def test_sharded_check_passes(flags):
    proc = _run(["-m", "repro_torch.launch.sharded_check", "--stages", "4",
                 *flags])
    last = proc.stdout.strip().splitlines()[-1]
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert last.startswith("SHARDED_CHECK ok stages=4"), last
    assert "bit_identical=1" in last
    if "--async" in flags:
        assert "async=1" in last and "quant=1" in last
    else:
        assert "paged=1" in last


def test_sharded_check_fails_loudly_on_a_mismatch():
    proc = _run(["-c", _BROKEN, "--stages", "2"])
    assert proc.returncode == 1
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("SHARDED_CHECK fail stages=2"), last
    assert "AssertionError" in last
    assert "SHARDED_CHECK ok" not in proc.stdout
