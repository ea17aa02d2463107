"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration file, its mix (``mixes/<traffic>.json``) and each metric's
reader (``metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], cfg, mix,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: dict):
    """The module of ``metrics/<name>.py``, checked against the entry."""
    path = HERE / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location(
        "specbench.metrics." + metric["name"].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("name", "unit", "source"):
        if getattr(mod, key.upper()) != metric[key]:
            raise ValueError(f"{path.name}: {key} differs from BENCHMARK.json")
    for key in ("layer", "moves"):
        if key in metric and getattr(mod, key.upper()) != metric[key]:
            raise ValueError(f"{path.name}: {key} differs from BENCHMARK.json")
    return mod
