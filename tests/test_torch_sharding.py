"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's ``repro.launch.sharding`` on both production meshes, for
every arch: each weight's, each ZeRO-1 optimizer leaf's and each cache
leaf's shard shape equals what the JAX rules give on a
``jax.sharding.AbstractMesh`` of the same axes (no devices needed),
leaf by leaf through the reference's key paths; so do the bytes one
device holds.  Caches at the dry run's shapes: prefill's stacked layout
(batch 32), decode's serving layout (batch 128) and long_500k's (batch
1, the sequence over 'data').  Everything is compared exactly.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jreg
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch import configs as reg
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import (batch_sharding_spec, data_axes,
                                     make_host_mesh, make_production_mesh)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# (prefill's stacked layout, decode_32k, long_500k): batch, rows, layout
CACHES = ((32, 32768, True, False), (128, 32768, False, False),
          (1, 524288, False, True))


def _jpath(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _meshes(multi_pod):
    sizes, names = MESHES[multi_pod]
    return (AbstractMesh(sizes, names),
            make_production_mesh(multi_pod=multi_pod))


def _compare(jtree, jspec_fn, leaves, spec_fn, am, mesh, itemsize=None):
    """Shard shapes leaf by leaf, and per-device bytes, of the JAX rule
    over ``jtree`` and the port's over ``leaves``."""
    ours = {path: (shape, dt) for path, shape, dt in leaves}
    want_bytes = 0
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    assert set(ours) == {_jpath(p) for p, _ in flat}
    for path, leaf in flat:
        key = _jpath(path)
        want = NamedSharding(am, jspec_fn(path, leaf)).shard_shape(
            leaf.shape)
        got = sharding.shard_shape(ours[key][0], spec_fn(key, ours[key][0]),
                                   mesh)
        assert tuple(want) == got, (key, want, got)
        want_bytes += int(np.prod(want)) * (itemsize or leaf.dtype.itemsize)
    assert sharding.device_bytes(
        leaves, spec_fn, mesh,
        None if itemsize is None else _torch_dtype(itemsize)) == want_bytes


def _torch_dtype(itemsize):
    import torch
    return {4: torch.float32, 2: torch.bfloat16}[itemsize]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_param_and_zero1_shards_match_jax(arch, multi_pod):
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    am, mesh = _meshes(multi_pod)
    jp = jspecs.param_specs(jcfg)
    leaves = sharding.param_leaves(specs.param_specs(cfg))
    _compare(jp, lambda p, x: jsh.param_pspec(p, x, jcfg, am), leaves,
             lambda p, s: sharding.param_pspec(p, s, cfg, mesh), am, mesh)
    # the optimizer's moments in fp32
    _compare(jp, lambda p, x: jsh.zero1_pspec(p, x, jcfg, am), leaves,
             lambda p, s: sharding.zero1_pspec(p, s, cfg, mesh), am, mesh,
             itemsize=4)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_cache_shards_match_jax(arch, multi_pod):
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    am, mesh = _meshes(multi_pod)
    for batch, rows, seq, stacked in ((b, r, s, st)
                                      for b, r, st, s in CACHES):
        jc = jspecs.cache_specs(jcfg, batch, rows, stacked=stacked)
        leaves = sharding.cache_leaves(cfg, specs.cache_specs(cfg, batch,
                                                              rows),
                                       stacked=stacked)
        _compare(jc, lambda p, x: jsh.cache_pspec(
            p, x, jcfg, am, batch=batch, shard_seq=seq), leaves,
            lambda p, s: sharding.cache_pspec(p, s, cfg, mesh, batch=batch,
                                              shard_seq=seq), am, mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_and_batch_specs_match_jax(multi_pod):
    """The production meshes' axes, the data axes and the batch specs of
    the dry run's batches; the host mesh over what exists."""
    am, mesh = _meshes(multi_pod)
    assert mesh.axis_names == am.axis_names
    assert mesh.shape == dict(am.shape)
    assert mesh.size == 512 if multi_pod else 256
    assert data_axes(mesh) == tuple(a for a in am.axis_names
                                    if a in ("pod", "data"))
    for batch in (1, 32, 128, 256):
        want = jsh.batch_shardings(am, batch, 2).spec
        got = sharding.batch_pspec(mesh, batch, 2)
        # a PartitionSpec writes a one-axis tuple as the axis
        assert tuple(want) == tuple(
            ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
            for ax in got), batch
        assert batch_sharding_spec(mesh, batch) == (
            data_axes(mesh) if batch % (mesh.size // 16) == 0 else None)
    host = make_host_mesh(4, 2)       # no card here: one device
    assert host.shape == {"data": 1, "model": 1} and host.size == 1


def test_shard_shape_refuses_an_axis_that_does_not_divide():
    mesh = make_production_mesh()
    assert sharding.shard_shape((32, 48), ("data", None), mesh) == (2, 48)
    assert sharding.shard_shape((4, 512), (None, ("data", "model")),
                                mesh) == (4, 2)
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_shape((40, 8), ("model", None), mesh)
