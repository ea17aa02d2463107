"""The port stands alone: importing it (and ``chip_smoke.py``) loads
neither JAX nor the JAX package, and its entry points refuse to run
without CUDA unless the caller asks for the CPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
db = ["models.paging", "kernels.paged", "core.dynbatch",
      "serving.scheduler", "serving.executor", "serving.dynbatch",
      "core.baselines", "core.chain", "core.sim", "data.pipeline",
      "optim.adamw", "launch.steps", "launch.train", "launch.pipeline",
      "launch.sharded_check", "counting", "models.moe", "models.encdec",
      "models.frontends", "models.ssm", "models.rglru",
      "configs.deepseek_v2_236b", "configs.gemma_7b",
      "configs.moonshot_v1_16b_a3b", "configs.qwen1_5_32b",
      "configs.qwen2_5_32b", "configs.qwen2_moe_a2_7b",
      "configs.internvl2_26b", "configs.mamba2_130m",
      "configs.recurrentgemma_9b", "configs.whisper_base"]
missing = [m for m in db if "repro_torch." + m not in sys.modules]
assert not missing, missing
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c",
                           _IMPORT_ALL.format(root=str(ROOT))],
                          capture_output=True, text=True, env=_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20      # every module was imported


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.configs import pipedec_pair
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pipedec_pair.DRAFT_SMOKE
    for call in (lambda: tf.init_model(cfg),
                 lambda: tf.init_cache(cfg, 1, 8),
                 lambda: serve.build_bundle("pipedec-draft", seed=0),
                 lambda: serve.main(["--mode", "pp", "--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    """Without CUDA, or copied away from the repository, the smoke script
    exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert ("no src/repro_torch" if alone else "CUDA is not available") \
        in proc.stderr
