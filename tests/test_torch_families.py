"""The attention families of the port against the JAX package on bridged
weights: Qwen 2.5 and 1.5 (QKV bias), Gemma (GeGLU, tied embedding),
Moonlight and Qwen-MoE (MoE, dense first layers, QKV bias) and DeepSeek-V2
(MoE + MLA), at their smoke sizes.

The JAX parameter pytree comes from the JAX package's ``init_model`` (its
layout: ``prefix`` dense layers, then the ``stack``), with numpy noise on
the QKV biases and the norm scales (the reference draws zeros and ones);
inputs are drawn with numpy from a seed.  Both packages then run prefill,
decode, tree verification, the two-level commit and the training forward
(with the MoE router term) on the same inputs.  Tolerance: logits within
1e-5 (fp32 sums in another order).  Also here: the registry against the
JAX one, the bridge in both directions for every new leaf, ``quantize()``
bit-equal to the JAX one for the dense new families and its refusal of
MoE and MLA, the ring's refusal, and the serving CLI with
``--target-arch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.speculative import ModelBundle as JaxBundle
from repro.launch import pipeline as jpl
from repro.models import transformer as jtf
from repro_torch import configs as reg
from repro_torch.checkpoint import from_jax_params, to_jax_params
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline, serve
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

ATOL = 1e-5
FAMILIES = ("qwen2.5-32b", "qwen1.5-32b", "gemma-7b", "moonshot-v1-16b-a3b",
            "qwen2-moe-a2.7b", "deepseek-v2-236b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    """The port's copy of a JAX config (nested configs by value)."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def family_params(jcfg, seed: int):
    """The JAX package's parameter pytree for ``jcfg`` as numpy arrays,
    with numpy noise on the QKV biases and norm scales."""
    params = jax.device_get(jtf.init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def noisy(path, x):
        name = getattr(path[-1], "key", None)
        if name in ("b_q", "b_k", "b_v"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "scale" and x.dtype == np.float32:
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(noisy, params)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(port cfg, JAX bundle, port model, numpy params), same weights."""
    jcfg = jreg.get_config(request.param, smoke=True)
    params = family_params(jcfg, seed=3)
    cfg = port_cfg(jcfg)
    return (cfg, JaxBundle(jax.tree.map(jnp.asarray, params), jcfg),
            from_jax_params(cfg, params, device="cpu"), params)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_registry_matches_jax():
    """Every arch id, alias, full and smoke config equals the JAX
    registry's, field for field."""
    assert reg.ARCH_IDS == jreg.ARCH_IDS
    assert reg.ALIASES == jreg.ALIASES
    for arch in [*jreg.ALIASES, *jreg.ARCH_IDS]:
        for smoke in (False, True):
            want = jreg.get_config(arch, smoke=smoke)
            got = reg.get_config(arch, smoke=smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    assert set(reg.all_configs()) == set(jreg.all_configs())
    with pytest.raises(KeyError):
        reg.get_config("no-such-model")


def test_unsupported_families_name_the_next_slice():
    """Every family of the registry runs; the boundary now lies inside
    the recurrent families: their tree verify names chain-mode, and their
    int8 form is refused (dense attention only)."""
    for arch in ("mamba2-130m", "recurrentgemma-9b"):
        cfg = reg.get_config(arch, smoke=True)
        tf.Transformer(cfg, "meta")
        with pytest.raises(NotImplementedError, match="chain-mode"):
            tf.check_tree_supported(cfg)
        with pytest.raises(NotImplementedError, match="dense attention"):
            tf.check_supported(dataclasses.replace(cfg, quant="int8"))
    for arch in (*FAMILIES, "whisper-base", "internvl2-26b",
                 "mamba2-130m", "recurrentgemma-9b"):
        tf.check_supported(reg.get_config(arch))


def test_prefill_decode_logits_match_jax(family):
    cfg, jb, model, _ = family
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


def test_tree_verify_commit_logits_match_jax(family):
    """Two tree layers with per-row prefixes and write offsets (a padded
    row), the commit of a tree row, then a decode that reads it."""
    cfg, jb, model, _ = family
    rng = np.random.default_rng(1)
    b, s, n, tcap = 2, 6, 4, 13
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    _, jc = jb.prefill(jnp.asarray(tokens), jb.init_cache(b, 16))
    _, tc = tf.prefill(model, tokens, tf.init_cache(cfg, b, 16,
                                                    device="cpu"))
    jtc = jb.init_tree_caches(b, tcap)
    ttc = tf.init_tree_caches(cfg, b, tcap, device="cpu")
    cache_len = np.array([s, s - 2], np.int32)
    for write_at in ([0, 0], [4, 1]):
        nt = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
        pos = (cache_len[:, None] + rng.integers(0, 3, (b, n))).astype(
            np.int32)
        mask = rng.random((b, n, tcap)) < 0.5
        mask[:, :, 0] = True
        mask[1, -1] = False
        jl, jtc = jb.tree_verify(jnp.asarray(nt), jnp.asarray(pos),
                                 jnp.asarray(mask), jc,
                                 jnp.asarray(cache_len), jtc,
                                 jnp.asarray(write_at, np.int32))
        tl, ttc = tf.tree_verify_step(model, nt, pos, mask, tc, cache_len,
                                      ttc, write_at)
        _close(tl, jl)
    jc = jb.commit(jc, jtc, 2, s)
    tf.commit_tree_node(tc, ttc, 2, s)
    for layer_cache, layer_tree in zip(tc, ttc):
        for name, buf in layer_cache.items():
            assert torch.equal(buf[:, s], layer_tree[name][:, 2])
    tok = np.array([5, 7], np.int32)
    jl, _ = jb.decode(jnp.asarray(tok), jc, s + 1)
    tl, _ = tf.decode_step(model, tok, tc, s + 1)
    _close(tl, jl)


def test_forward_logits_and_router_term_match_jax(family):
    cfg, jb, model, params = family
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (2, 11)).astype(np.int32)
    jl, jaux = jtf.forward(jb.params, jb.cfg, jnp.asarray(tokens))
    tl, taux = tf.forward(model, torch.as_tensor(tokens).long(),
                          with_aux=True)
    _close(tl.detach(), jl)
    _close(taux.detach(), jaux, atol=1e-6)
    assert (float(taux) > 0) == (cfg.moe is not None)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def test_bridge_round_trip_carries_every_leaf(family):
    """JAX -> port -> JAX gives every leaf back (prefix/stack layout,
    biases, router, 3-D experts, shared experts, MLA, MLP without w_gate),
    and the port's weights sit where the JAX layout says."""
    cfg, _, model, params = family
    back = dict(_leaves(to_jax_params(model)))
    want = dict(_leaves(params))
    assert back.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(back[path], want[path], str(path))
    n_prefix = cfg.moe.first_dense if cfg.moe is not None else 0
    last = model.layers[-1]
    np.testing.assert_array_equal(
        last.mixer.w_o.numpy(),
        params["stack"][0]["mixer"]["w_o"][cfg.num_layers - n_prefix - 1])
    if n_prefix:
        np.testing.assert_array_equal(
            model.layers[0].ffn.w_down.numpy(),
            params["prefix"][0][0]["ffn"]["w_down"])
    bad = jax.tree.map(lambda x: x, params)
    bad["stack"][0]["mixer"]["extra"] = bad["stack"][0]["mixer"]["w_o"]
    with pytest.raises(ValueError, match="extra"):
        from_jax_params(cfg, bad, device="cpu")


def test_gelu_mlp_bridges_without_gate():
    """The plain GELU MLP (whisper's variant) has no w_gate: a dense
    config with it runs and bridges both ways against JAX's forward."""
    jcfg = dataclasses.replace(jreg.get_config("gemma-7b", smoke=True),
                               mlp_variant="gelu", name="gelu-dense")
    params = family_params(jcfg, seed=4)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    assert not hasattr(model.layers[0].ffn, "w_gate")
    tokens = np.arange(7, dtype=np.int32)[None] * 5
    jl, _ = jtf.forward(jax.tree.map(jnp.asarray, params), jcfg,
                        jnp.asarray(tokens))
    _close(tf.forward(model, torch.as_tensor(tokens).long()).detach(), jl)
    assert dict(_leaves(to_jax_params(model))).keys() == \
        dict(_leaves(params)).keys()


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma-7b"])
def test_quantize_dense_families_bit_equal_to_jax(arch):
    """quantize() of Qwen 2.5 (QKV bias, kept fp32) and Gemma (GeGLU)
    equals the JAX package's carried across, buffer for buffer; int8
    logits agree with JAX's int8 path."""
    jcfg = jreg.get_config(arch, smoke=True)
    params = family_params(jcfg, seed=5)
    cfg = reg.get_config(arch, smoke=True)
    port = ModelBundle(from_jax_params(cfg, params, device="cpu"))
    jx = JaxBundle(jax.tree.map(jnp.asarray, params), jcfg)
    qport, qjax = port.quantize(), jx.quantize()
    bridged = from_jax_params(dataclasses.replace(cfg, quant="int8"),
                              jax.device_get(qjax.params), device="cpu")
    got, want = qport.model.state_dict(), bridged.state_dict()
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    if cfg.qkv_bias:
        assert qport.model.layers[0].mixer.b_q.dtype == torch.float32
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                               (1, 7)).astype(np.int32)
    jl, _ = qjax.prefill(jnp.asarray(tokens), qjax.init_cache(1, 16))
    tl, _ = qport.prefill(tokens, qport.init_cache(1, 16))
    _close(tl, jl, atol=1e-4)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_quantize_refuses_moe_and_mla(arch):
    cfg = reg.get_config(arch, smoke=True)
    bundle = ModelBundle(tf.init_model(cfg, seed=0, device="cpu"))
    with pytest.raises(NotImplementedError, match="dense attention"):
        bundle.quantize()
    with pytest.raises(AssertionError):
        jcfg = jreg.get_config(arch, smoke=True)
        JaxBundle(jtf.init_model(jax.random.PRNGKey(0), jcfg),
                  jcfg).quantize()
    with pytest.raises(NotImplementedError, match="dense attention"):
        tf.Transformer(dataclasses.replace(cfg, quant="int8"), "meta")


# the ring's accept-or-refuse table: what the reference's stage_layout
# accepts (None) or the reason both packages refuse
RING_TABLE = {"qwen2-moe-a2.7b": None, "gemma-7b": None,
              "deepseek-v2-236b": "uniform layer stack",
              "moonshot-v1-16b-a3b": "uniform layer stack"}


@pytest.mark.parametrize("arch", list(RING_TABLE))
def test_ring_refuses_new_families(arch):
    """``stage_layout`` accepts Qwen-MoE and Gemma with the reference's
    layout and refuses DeepSeek-V2 and Moonlight (``moe.first_dense`` 1:
    a dense layer before the MoE stack), as the reference's does."""
    cfg, jcfg = (r.get_config(arch, smoke=True) for r in (reg, jreg))
    reason = RING_TABLE[arch]
    if reason is None:
        assert pipeline.stage_layout(cfg, 2) == jpl.stage_layout(jcfg, 2)
        return
    with pytest.raises(NotImplementedError, match=f"{reason}.*first_dense"):
        pipeline.stage_layout(cfg, 2)
    with pytest.raises(AssertionError, match=reason):
        jpl.stage_layout(jcfg, 2)


@pytest.mark.parametrize("arch,mode", [("qwen2-moe-a2.7b", "pipedec"),
                                       ("gemma-7b", "pipedec-db")])
def test_cli_target_arch_on_cpu(arch, mode, capsys):
    """``--target-arch`` serves a family at its smoke size with the
    default draft; tokens equal autoregressive decoding."""
    engine, results = serve.main(["--mode", mode, "--device", "cpu",
                                  "--target-arch", arch, "--requests", "2",
                                  "--new-tokens", "5", "--stages", "2",
                                  "--slots", "2"])
    assert engine.target.cfg == reg.get_config(arch, smoke=True)
    assert engine.draft.cfg == reg.get_config("pipedec-draft", smoke=True)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    rng = np.random.default_rng(0)
    for uid in range(2):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(
            results[uid].tokens,
            generate_autoregressive(engine.target, prompt, 5))
