"""The reference's production meshes, as descriptions: the port of the JAX
package's ``repro/launch/mesh.py``.

A ``Mesh`` is axis names and sizes, and it places no tensor.  The port
runs on one card, or on the cards of one host as a pipeline
(``launch.pipeline.hop``), never as an SPMD mesh: NCCL refuses two ranks
on one card, and there is no ``torch.distributed`` here.  The mesh exists
so that the dry run (``launch.dryrun``) can count what each device of the
reference's deployment would hold under the sharding rules
(``launch.sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, in order."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Size by axis name (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def desc(self) -> str:
        """The sizes joined by x, e.g. ``16x16``."""
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The paper-scale mesh: (data=16, model=16), or (pod=2, data=16,
    model=16) with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, data: int = 1) -> Mesh:
    """A small (data, model) mesh over the cards that exist
    (``torch.cuda.device_count()``; 1 without a card)."""
    import torch
    devices = max(1, torch.cuda.device_count())
    model = min(model, devices)
    data = max(1, min(data, devices // model))
    return Mesh(("data", "model"), (data, model))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes usable for batch sharding (('pod',) 'data')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_sharding_spec(mesh: Mesh, batch: int):
    """The batch over ('pod', 'data') when it divides, else None
    (replicated; long_500k, batch 1, shards the cache's sequence
    instead)."""
    axes = data_axes(mesh)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return axes if batch % total == 0 else None
