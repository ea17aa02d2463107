"""MoE and MLA in the port against the JAX package.

``moe_forward`` and ``route`` against the JAX functions on the same numpy
weights and tokens: at dropless capacity, at a capacity that drops copies
(the same copies dropped, so the same output), and with router
probabilities that tie (the lower expert id first, as ``jax.lax.top_k``
orders them).  MLA's absorbed decode against the JAX ``attn_decode``.
Tolerance: 1e-5 on outputs (fp32 sums in another order).  ``bundles``
builds the family pairs that ``test_torch_family_pipedec.py`` and
``test_torch_family_db.py`` serve.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.speculative import ModelBundle
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _moe_pair(jcfg, seed):
    """JAX MoE params (numpy) and the port's MoE module holding them."""
    params = jax.tree.map(np.array, jax.device_get(
        jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)))
    mod = moe.MoE(port_cfg(jcfg), "cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(mod, name).copy_(torch.as_tensor(params[name]))
        for name, w in params.get("shared", {}).items():
            getattr(mod.shared, name).copy_(torch.as_tensor(w))
    return params, mod


def _moe_cfg(arch="qwen2-moe-a2.7b", **kw):
    jcfg = jreg.get_config(arch, smoke=True)
    return dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **kw))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_forward_matches_jax(arch, capacity_factor):
    """Dropless (the number of experts as the factor) and a capacity that
    drops copies: the same output and router term."""
    base = jreg.get_config(arch, smoke=True)
    jcfg = _moe_cfg(arch, capacity_factor=capacity_factor or float(
        base.moe.num_experts))
    params, mod = _moe_pair(jcfg, seed=1)
    x = np.random.default_rng(2).normal(size=(3, 16, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = jmoe.moe_forward(jax.tree.map(jnp.asarray, params), jcfg,
                                jnp.asarray(x))
    y, aux = moe.moe_forward(mod, port_cfg(jcfg), torch.as_tensor(x))
    _close(y, jy)
    _close(aux, jaux, atol=1e-6)
    idx, _, _ = moe.route(mod, port_cfg(jcfg), torch.as_tensor(x).reshape(
        -1, jcfg.d_model))
    most = int(torch.bincount(idx.reshape(-1)).max())
    cap = moe.capacity(48, port_cfg(jcfg))
    assert cap == jmoe.capacity(48, jcfg)
    assert (most > cap) == (capacity_factor is not None)   # drops happen


def test_capacity_floor_matches_jax():
    for cf in (0.1, 1.0, 1.25, 4.0):
        jcfg = _moe_cfg(capacity_factor=cf)
        for t in (1, 7, 8, 24, 100):
            assert moe.capacity(t, port_cfg(jcfg)) == jmoe.capacity(t, jcfg)


def test_router_ties_take_the_lower_expert():
    """Experts 1 and 2 share a router column and so tie on every token:
    the port orders the tie as jax.lax.top_k does, and the outputs
    agree."""
    jcfg = _moe_cfg(capacity_factor=4.0)
    params, mod = _moe_pair(jcfg, seed=3)
    params["router"][:, 2] = params["router"][:, 1]
    with torch.no_grad():
        mod.router[:, 2] = mod.router[:, 1]
    x = np.random.default_rng(4).normal(size=(20, jcfg.d_model)).astype(
        np.float32)
    jidx, jgate, _ = jmoe.route(jax.tree.map(jnp.asarray, params), jcfg,
                                jnp.asarray(x))
    idx, gate, _ = moe.route(mod, port_cfg(jcfg), torch.as_tensor(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gate, jgate)
    assert (np.asarray(jidx) == 1).any() and (np.asarray(jidx) == 2).any()
    jy, _ = jmoe.moe_forward(jax.tree.map(jnp.asarray, params), jcfg,
                             jnp.asarray(x[None]))
    y, _ = moe.moe_forward(mod, port_cfg(jcfg), torch.as_tensor(x[None]))
    _close(y, jy)


def test_mla_absorbed_decode_matches_jax():
    """One MLA layer (DeepSeek smoke): a prompt through attn_forward, then
    decode steps in the absorbed form, against the JAX functions."""
    jcfg = jreg.get_config("deepseek-v2-236b", smoke=True)
    cfg = port_cfg(jcfg)
    params = jax.tree.map(np.array, jax.device_get(
        jattn.init_attention(jax.random.PRNGKey(7), jcfg)))
    p = attn.MLAttention(cfg, "cpu")
    with torch.no_grad():
        for name, w in params.items():
            getattr(p, name).copy_(torch.as_tensor(w))
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(8)
    b, s, max_len = 2, 6, 12
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    jcache = jattn.init_kv_cache(jcfg, b, max_len)
    jy, jcache = jattn.attn_forward(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), cache=jcache)
    cache = attn.init_kv_cache(cfg, b, max_len, "cpu")
    y, _ = attn.attn_forward(p, cfg, torch.as_tensor(x),
                             torch.as_tensor(pos), cache=cache)
    _close(y, jy)
    for step in range(3):
        xt = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        position = np.full((b,), s + step)
        jy, jcache = jattn.attn_decode(jp, jcfg, jnp.asarray(xt),
                                       jnp.asarray(position), jcache,
                                       s + step)
        y, _ = attn.attn_decode(p, cfg, torch.as_tensor(xt),
                                torch.as_tensor(position), cache,
                                [s + step], torch.as_tensor(position + 1))
        _close(y, jy)
    for name in ("c_kv", "k_rope"):
        _close(cache[name], jcache[name])


def draft_for(vocab: int) -> ModelConfig:
    return ModelConfig(name="fam-draft", family="dense", num_layers=1,
                       d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
                       vocab_size=vocab)


def bundles(arch, seed, capacity_factor=None):
    """{(port, JAX) bundles} of a family target at dropless MoE capacity
    (as the JAX family test), or at ``capacity_factor`` when given, and
    the one-layer dense draft."""
    jcfg = jreg.get_config(arch, smoke=True)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor or float(
                jcfg.moe.num_experts)))
    out = {}
    for name, c, s in (("target", jcfg, seed),
                       ("draft", JaxModelConfig(**dataclasses.asdict(
                           draft_for(jcfg.vocab_size))), seed + 5)):
        params = jax.device_get(jtf.init_model(jax.random.PRNGKey(s), c))
        out[name] = (ModelBundle(from_jax_params(port_cfg(c), params,
                                                 device="cpu")),
                     JaxBundle(jax.tree.map(jnp.asarray, params), c))
    return out
