"""Seeded weights, drawn on the device in a few large calls, and the
program's model built around them.

The draw is one flat float32 buffer filled from a ``torch.Generator`` on the
device in chunks; each weight is a view of it, scaled in place as its spec
says.  The reference reads these tensors; the program's ``Transformer``,
built on the meta device, takes the same tensors (``load_state_dict(assign=
True)``), so both sides see the same weights and the program made none of
them.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

CHUNK = 1 << 30       # elements drawn per call


def torch_seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 63), tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make(spec: list, seed: int, device) -> dict:
    """{name: tensor} for ``spec`` [(name, shape, (kind, std))]."""
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 0))
    for a in range(0, flat.numel(), CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for (name, shape, (kind, std)), n in zip(spec, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        t.mul_(std)
        if kind == "one_plus":
            t.add_(1.0)
        elif kind != "normal":
            raise ValueError(f"unknown init {kind!r} for {name}")
        out[name] = t
    return out


def family(cfg: dict):
    """(reference module, port adapter module) of the file's model type."""
    kind = cfg["model_type"]
    return (importlib.import_module(f"specbench.reference.{kind}"),
            importlib.import_module(f"specbench.ports.{kind}"))


def port_model(cfg: dict, weights: dict):
    """The program's ``ModelBundle`` over ``weights``."""
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models.transformer import Transformer
    _, port = family(cfg)
    model = Transformer(port.model_config(cfg), torch.device("meta"))
    model.load_state_dict(port.state_dict(weights, cfg), strict=True,
                          assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return ModelBundle(model)
