"""Registry of the ten published architectures and the paper's own pair:
the port's copy of the JAX package's ``repro/configs`` (plain data).

Each module holds ``FULL`` (the published configuration) and ``SMOKE`` (a
small model of the same family for the CPU tests and the smoke CLI).
``pipedec_pair`` holds the paper's target and draft.  Every configuration
is known here; ``models.transformer.check_supported`` says which of them
the port runs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "moonshot_v1_16b_a3b",
    "qwen2_moe_a2_7b",
    "whisper_base",
    "gemma_7b",
    "internvl2_26b",
    "mamba2_130m",
    "qwen2_5_32b",
    "recurrentgemma_9b",
    "qwen1_5_32b",
    "deepseek_v2_236b",
]

# the public ids, with dashes and dots
ALIASES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-base": "whisper_base",
    "gemma-7b": "gemma_7b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-130m": "mamba2_130m",
    "qwen2.5-32b": "qwen2_5_32b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-32b": "qwen1_5_32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    # the paper's own experiment pair
    "pipedec-target": "pipedec_pair",
    "pipedec-draft": "pipedec_pair",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCH_IDS and name != "pipedec_pair":
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``arch`` (a public id, an alias or a
    module name), or its smoke-sized model."""
    mod = _module(arch)
    if arch == "pipedec-draft":
        return mod.DRAFT_SMOKE if smoke else mod.DRAFT
    if arch == "pipedec-target":
        return mod.TARGET_SMOKE if smoke else mod.TARGET
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    """Every published architecture's configuration by module name."""
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}
