"""Smoke-sized cells for the benchmark's CPU tests: the two configuration
files cut to the registry's smoke widths, a small mix, and a run of the
harness's whole path on the CPU (no look for a card)."""
from __future__ import annotations

import json
import time

import torch

from specbench.lib import bench, check, serve

CONFIGS = bench.HERE / "configs"
MIXES = bench.HERE / "mixes"

SMOKE = {
    "qwen2": dict(name="qwen2.5-smoke", hidden_size=160,
                  num_attention_heads=5, num_key_value_heads=1,
                  intermediate_size=448, vocab_size=512,
                  num_hidden_layers=2),
    "qwen2_moe": dict(name="qwen2-moe-smoke", hidden_size=128,
                      num_attention_heads=4, num_key_value_heads=4,
                      intermediate_size=352, moe_intermediate_size=88,
                      shared_expert_intermediate_size=176, num_experts=4,
                      num_experts_per_tok=2, vocab_size=512,
                      num_hidden_layers=2),
}


def config(kind: str) -> dict:
    """A configuration file of ``kind`` at smoke size; the MoE at dropless
    capacity (factor experts / top-k)."""
    name = {"qwen2": "qwen2.5-32b-l8", "qwen2_moe": "qwen1.5-moe-a2.7b-l8"}
    cfg = json.loads((CONFIGS / f"{name[kind]}.json").read_text())
    cfg.update(SMOKE[kind])
    if kind == "qwen2_moe":
        cfg["assumed"] = {**cfg["assumed"], "capacity_factor":
                          cfg["num_experts"] / cfg["num_experts_per_tok"]}
    return cfg


def mix(requests: int = 400) -> dict:
    """The decode mix at smoke lengths on 4 slots; the check reads every
    request a short CPU window serves (up to 16), so that a fault in any
    slot shows whatever the window's length."""
    m = json.loads((MIXES / "db-decode.json").read_text())
    m.update(requests=requests, block=8, clients=4,
             prompt_tokens={"dist": "loguniform", "min": 8, "max": 32},
             output_tokens={"dist": "uniform", "min": 4, "max": 12},
             check={"requests": 16})
    m["serving"] = {**m["serving"], "slots": 4, "n_stages": 4}
    return m


def run(kind: str, seed: int, seconds: float = 1.0, traced: bool = False):
    """One run of the smoke cell on the CPU (torch on one thread)."""
    torch.set_num_threads(1)
    return serve.run(config(kind), mix(), seed, seconds, traced,
                     torch.device("cpu"), time.perf_counter())


# the smoke cells' limits: float32 on both sides of the CPU
LIMITS = {"max_logit_gap": 1e-3, "logit_dist": 1e-4}


def verdict(r, seed: int, monkeypatch) -> dict:
    """``check.check`` of a smoke run against the smoke limits."""
    monkeypatch.setattr(check, "MIN_TOKENS", 8)
    monkeypatch.setattr(check, "limits_of", lambda cfg: LIMITS)
    return check.check(r, seed, torch.device("cpu"))
