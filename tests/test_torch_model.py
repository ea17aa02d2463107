"""The port's dense model against the JAX package's on bridged weights.

The JAX parameter pytree (numpy) is carried into the port's modules by
``repro_torch.checkpoint.bridge``; both packages then run prefill, decode
and tree verification on the same numpy inputs.  Tolerance: logits within
atol 1e-4 (fp32 matmuls and attention summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.config import MLAConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import (from_jax_params, load_jax_params,
                                    load_pytree)
from repro_torch.configs import get_config, pipedec_pair
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def jax_cfg(cfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def _tiny():
    return ModelConfig(name="t-dense", family="dense", num_layers=3,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=128)


CONFIGS = {"target-smoke": pipedec_pair.TARGET_SMOKE,
           "draft-smoke": pipedec_pair.DRAFT_SMOKE, "tiny-dense": _tiny()}


def numpy_params(cfg, seed: int):
    """A JAX dense-model parameter pytree (the layout ``init_model``
    builds, layers stacked on a leading axis) drawn with numpy, norm scales
    included, so both packages get the same weights from a seed."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    n_l, ff, vocab = cfg.num_layers, cfg.d_ff, cfg.vocab_size

    def w(*shape, fan_in):
        return (rng.normal(size=(n_l, *shape)) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(*shape):
        return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)

    stack = {"norm1": {"scale": scale(n_l, d)},
             "mixer": {"w_q": w(d, h, hd, fan_in=d),
                       "w_k": w(d, kv, hd, fan_in=d),
                       "w_v": w(d, kv, hd, fan_in=d),
                       "w_o": w(h, hd, d, fan_in=hd)},
             "norm2": {"scale": scale(n_l, d)},
             "ffn": {"w_gate": w(d, ff, fan_in=d), "w_up": w(d, ff, fan_in=d),
                     "w_down": w(ff, d, fan_in=ff)}}
    params = {"embed": {"table": (0.02 * rng.normal(size=(vocab, d))).astype(
        np.float32)}, "final_norm": {"scale": scale(d)}, "stack": [stack]}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": (0.02 * rng.normal(
            size=(vocab, d))).astype(np.float32)}
    return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(port cfg, jitted JAX bundle, bridged port model), same weights."""
    cfg = CONFIGS[request.param]
    params = numpy_params(cfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, params)
    return (cfg, JaxBundle(jparams, jax_cfg(cfg)),
            from_jax_params(cfg, params, device="cpu"))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_prefill_decode_logits_match_jax(pair):
    cfg, jb, model = pair
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 9, 24
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jb.prefill(jnp.asarray(tokens), jb.init_cache(b, max_len))
    tl, tc = tf.prefill(model, tokens, tf.init_cache(cfg, b, max_len,
                                                     device="cpu"))
    _close(tl, jl)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jb.decode(jnp.asarray(tok), jc, s + step)
        tl, tc = tf.decode_step(model, tok, tc, s + step)
        _close(tl, jl)
    # the caches agree row for row (JAX stacks layers on a leading axis)
    _close(np.stack([c["k"].numpy() for c in tc]), jc["stack"][0]["k"])


def test_tree_verify_logits_match_jax(pair):
    cfg, jb, model = pair
    rng = np.random.default_rng(1)
    b, s, n, tcap = 2, 6, 4, 13
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    _, jc = jb.prefill(jnp.asarray(tokens), jb.init_cache(b, 16))
    _, tc = tf.prefill(model, tokens, tf.init_cache(cfg, b, 16,
                                                    device="cpu"))
    jtc = jb.init_tree_caches(b, tcap)
    ttc = tf.init_tree_caches(cfg, b, tcap, device="cpu")
    cache_len = np.array([s, s - 2], np.int32)        # per-row prefixes
    for write_at in ([0, 0], [4, 1]):
        nt = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
        pos = (cache_len[:, None] + rng.integers(0, 3, (b, n))).astype(
            np.int32)
        mask = rng.random((b, n, tcap)) < 0.5
        mask[:, :, 0] = True
        mask[1, -1] = False                           # a padded row
        jl, jtc = jb.tree_verify(jnp.asarray(nt), jnp.asarray(pos),
                                 jnp.asarray(mask), jc,
                                 jnp.asarray(cache_len), jtc,
                                 jnp.asarray(write_at, np.int32))
        tl, ttc = tf.tree_verify_step(model, nt, pos, mask, tc, cache_len,
                                      ttc, write_at)
        _close(tl, jl)
    _close(np.stack([c["v"].numpy() for c in ttc]), jtc["stack"][0]["v"])
    # two-level cache sync: commit tree row 2 at row s of the model cache
    jc = jb.commit(jc, jtc, 2, s)
    tf.commit_tree_node(tc, ttc, 2, s)
    for name in ("k", "v"):
        _close(np.stack([c[name].numpy() for c in tc])[:, :, :s + 1],
               np.asarray(jc["stack"][0][name])[:, :, :s + 1], atol=1e-5)
        for layer_cache, layer_tree in zip(tc, ttc):
            assert torch.equal(layer_cache[name][:, s], layer_tree[name][:, 2])
    with pytest.raises(IndexError):
        tf.commit_tree_node(tc, ttc, 0, 16)


def test_bridge_from_npz_checkpoint(tmp_path):
    """save_pytree (JAX) -> load_pytree (port) -> the same weights as the
    in-memory bridge, key for key."""
    cfg = _tiny()
    params = jax.device_get(jtf.init_model(jax.random.PRNGKey(5),
                                           jax_cfg(cfg)))
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, {"params": params, "step": 7})
    loaded = load_pytree(path)
    assert int(loaded["step"]) == 7
    a = from_jax_params(cfg, loaded["params"], device="cpu")
    b = from_jax_params(cfg, params, device="cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)


def test_bridge_rejects_mismatched_tree():
    cfg = pipedec_pair.TARGET_SMOKE
    params = numpy_params(cfg, seed=0)
    model = tf.Transformer(dataclasses.replace(cfg, num_layers=3), "cpu")
    with pytest.raises(ValueError):
        load_jax_params(model, params)
    tied = tf.Transformer(dataclasses.replace(cfg, tie_embeddings=True),
                          "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        load_jax_params(tied, params)


def test_layers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5))
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           atol=1e-5)
    h = rng.normal(size=(3, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(layers.rmsnorm(torch.tensor(scale), torch.tensor(h)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h)),
           atol=1e-5)
    w = {k: rng.normal(size=s).astype(np.float32) / 6 for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    mlp = layers.MLP(32, 48, "cpu")
    for k, v in w.items():
        getattr(mlp, k).data.copy_(torch.tensor(v))
    _close(mlp(torch.tensor(h)),
           jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(h), "swiglu"), atol=1e-5)


def test_init_model_draws_the_jax_distributions():
    """Same distributions as the JAX initialisers (not the same values):
    embeddings N(0, 0.02^2), LeCun-normal projections, unit norms."""
    cfg = dataclasses.replace(pipedec_pair.TARGET_SMOKE, num_layers=1)
    m = tf.init_model(cfg, seed=0, device="cpu")
    assert abs(float(m.embed.table.std()) - 0.02) < 2e-3
    assert abs(float(m.layers[0].mixer.w_q.std()) - 256 ** -0.5) < 3e-3
    assert abs(float(m.layers[0].mixer.w_o.std()) - 32 ** -0.5) < 1e-2
    assert abs(float(m.layers[0].ffn.w_down.std()) - 704 ** -0.5) < 3e-3
    assert torch.equal(m.final_norm.scale, torch.ones(256))
    same = tf.init_model(cfg, seed=0, device="cpu")
    assert torch.equal(m.layers[0].mixer.w_k, same.layers[0].mixer.w_k)


def test_configs_keep_published_widths():
    t, d = get_config("pipedec-target"), get_config("pipedec-draft")
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.d_ff,
            t.vocab_size) == (80, 8192, 64, 8, 28672, 128256)
    assert (d.num_layers, d.d_model, d.num_heads, d.num_kv_heads, d.d_ff,
            d.tie_embeddings) == (16, 2048, 32, 8, 8192, True)
    assert t.rope_theta == d.rope_theta == 10000.0
    assert get_config("pipedec-draft", smoke=True) == \
        pipedec_pair.DRAFT_SMOKE
    g = get_config("gemma-7b")
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.resolved_head_dim, g.d_ff, g.vocab_size, g.mlp_variant,
            g.tie_embeddings) == (28, 3072, 16, 16, 256, 24576, 256000,
                                  "geglu", True)
    with pytest.raises(KeyError):
        get_config("gemma-9b")


def test_unsupported_families_are_refused():
    ssm = dataclasses.replace(_tiny(), family="ssm")
    with pytest.raises(NotImplementedError, match="ssm"):
        tf.Transformer(port_cfg(ssm), "cpu")
    mla = dataclasses.replace(_tiny(), mla=MLAConfig(kv_lora_rank=16),
                              quant="int8")
    with pytest.raises(NotImplementedError, match="dense attention"):
        tf.Transformer(port_cfg(mla), "cpu")


def test_cache_writes_never_clamp():
    """The JAX package's dynamic_update_slice clamps an overrunning write;
    the port refuses it."""
    cfg = _tiny()
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    model = tf.init_model(cfg, seed=1, device="cpu")
    with pytest.raises(IndexError):
        tf.decode_step(model, [3], cache, 8)
    jattn_rows = jattn.init_kv_cache(jax_cfg(cfg), 1, 8)["k"].shape
    assert tuple(cache[0]["k"].shape) == jattn_rows
