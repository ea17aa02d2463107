"""The port's launch specs against the JAX package's ``repro.launch.specs``
and ``repro.launch.analysis``: the benchmark shapes, the window override
and the model-FLOPs estimate for every arch x shape; each step's inputs
key by key (shape and dtype, the decode cache leaf by leaf in the
reference's serving layout); and the weights' and caches' leaves and
bytes against the reference's eval_shape totals for every arch.  The
port's stand-ins live on the meta device, so nothing here allocates at
published width.  Everything is compared exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jreg
from repro.launch import analysis as janalysis
from repro.launch import specs as jspecs
from repro_torch import configs as reg
from repro_torch.launch import analysis, sharding, specs


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def jax_leaves(tree) -> dict:
    """{key path: (shape, dtype name)} of a JAX pytree of shape specs
    (dict keys and list indices, as ``sharding.param_leaves`` gives)."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(leaf.shape), _dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(leaves) -> dict:
    return {path: (tuple(shape), _dtype(dt)) for path, shape, dt in leaves}


ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "int8": 1}


def _bytes(leaves: dict) -> int:
    return sum(int(np.prod(s)) * ITEMSIZE[d] for s, d in leaves.values())


def test_shapes_and_window_override_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}
    for arch in jreg.ARCH_IDS:
        jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
        for name in jspecs.SHAPES:
            assert specs.window_override(cfg, specs.SHAPES[name]) == \
                jspecs.window_override(jcfg, jspecs.SHAPES[name]), (arch,
                                                                    name)
            shape = specs.SHAPES[name]
            assert analysis.model_flops_estimate(cfg, shape, shape.kind) == \
                janalysis.model_flops_estimate(jcfg, jspecs.SHAPES[name],
                                               shape.kind)
    wo = {a: specs.window_override(reg.get_config(a),
                                   specs.SHAPES["long_500k"])
          for a in reg.ARCH_IDS}
    assert wo["qwen2_5_32b"] == 4096 and wo["mamba2_130m"] == -1
    assert wo["recurrentgemma_9b"] == -1 and wo["whisper_base"] == 4096


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every step's input keys, shapes and dtypes; the decode cache leaf
    by leaf through the reference's serving (``units``) layout."""
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    for name, shape in specs.SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, jspecs.SHAPES[name])
        assert set(got) == set(want), (arch, name)
        for key, w in want.items():
            if key == "cache":
                assert port_leaves(sharding.cache_leaves(
                    cfg, got[key], stacked=False)) == jax_leaves(w)
                assert all(t.device.type == "meta" for layer in got[key]
                           for t in layer.values())
                continue
            assert (tuple(got[key].shape), _dtype(got[key].dtype)) == (
                tuple(w.shape), _dtype(w.dtype)), (arch, name, key)
            assert got[key].device.type == "meta"


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_param_and_cache_leaves_and_bytes_match_eval_shape(arch):
    """The meta model's weights as the reference's leaves (path, shape,
    dtype: bf16 but the fp32 routers, SSD scalars and RG-LRU ``lambda``)
    and the bf16 cache's (RG-LRU's ``h`` fp32), stacked, equal the JAX
    eval_shape pytrees; so do the byte totals."""
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    model = specs.param_specs(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    got = port_leaves(sharding.param_leaves(model))
    want = jax_leaves(jspecs.param_specs(jcfg))
    assert got == want
    assert sum(p.numel() * p.element_size() for p in model.parameters()) \
        == _bytes(want)
    cache = specs.cache_specs(cfg, 2, 96)
    got = port_leaves(sharding.cache_leaves(cfg, cache))
    want = jax_leaves(jspecs.cache_specs(jcfg, 2, 96))
    assert got == want
    assert sum(t.numel() * t.element_size() for layer in cache
               for t in layer.values()) == _bytes(want)
