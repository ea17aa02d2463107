"""What the harness loads: nothing of the JAX stack or the JAX package
(top-level names compared whole, since ``repro_torch`` begins with
``repro``), and a reference that imports nothing of the program."""
import shutil
import subprocess
import sys

from specbench.lib import bench

ROOT = bench.ROOT


def run_python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "import specbench.run, runpy\n"
        "from specbench.lib import harness, bench\n"
        "from specbench.tests import smoke\n"
        "r = smoke.run('qwen2_moe', 11, seconds=0.5)\n"
        "c = bench.cell(bench.load(), 'qwen1.5-moe-a2.7b-l8.db-decode')\n"
        "import torch\n"
        "harness.result(c, r, 11, False, torch.device('cpu'))\n"
        "print('BAD', harness.forbidden_modules())\n"
        "print('TORCH', 'repro_torch' in sys.modules)\n")
    p = run_python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "BAD []" in p.stdout and "TORCH True" in p.stdout


def test_forbidden_names_are_compared_whole():
    from specbench.lib import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys.modules["sys"]
        assert "repro_torch_x" not in harness.forbidden_modules()
        sys.modules["repro.models"] = sys.modules["sys"]
        assert "repro.models" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_imports_nothing_of_the_program():
    p = run_python("import sys; sys.path[:0] = ['.', 'src']\n"
                   "import specbench.reference.qwen2_moe\n"
                   "import specbench.lib.counts, specbench.lib.traffic\n"
                   "print(sorted(m for m in sys.modules "
                   "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and the benchmark's folder without the program: the
    run stops before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "specbench", tmp_path / "specbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_python(
        "import sys, time; sys.path[:0] = ['.', 'src']\n"
        "from specbench.lib import bench, serve\n"
        "import torch\n"
        "c = bench.cell(bench.load(), 'qwen2.5-32b-l8.db-decode')\n"
        "serve.run(c.cfg, c.mix, 1, 1.0, False, torch.device('cpu'), "
        "time.perf_counter())\n", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "No module named 'repro_torch'" in p.stderr
    p = subprocess.run([sys.executable, "specbench/run.py", "--workload",
                        "qwen2.5-32b-l8.db-decode", "--seed", "1",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
