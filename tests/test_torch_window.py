"""The window override of the port against the JAX package on bridged
weights, at smoke size: ``window_override`` on the model entry points
``forward``, ``prefill``, ``decode_step`` and ``tree_verify_step``
(``prefill_chunk`` and ``loss_fn`` with its gradients are in
``test_torch_window_train.py``; ``ModelBundle``, ``quantize()`` and the
engines in ``test_torch_window_engines.py``; the ring in
``test_torch_window_ring.py``).

An override >= 0 replaces every attention layer's window, RecurrentGemma's
``local`` layers included (0: no window), as the reference's ``_window``
does; recurrent layers ignore it.  The configs: the paper's dense target,
Qwen 2.5 (QKV bias), Gemma with head_dim 256, DeepSeek-V2 (MLA and MoE),
InternVL2 (a vision prefix), Whisper (an encoder output) and
RecurrentGemma (RG-LRU beside local attention), each with windows of 0
and of 3 keys, shorter than the prompts.  The JAX pytree comes from the
JAX package's ``init_model`` with numpy noise on biases and norms
(``test_torch_families.family_params``); inputs are numpy draws from a
seed.

Tolerance: logits within 1e-4 (fp32 sums in another order through up to
5 layers, as ``test_torch_modality.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro_torch.checkpoint import from_jax_params
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from test_torch_families import family_params, port_cfg
from test_torch_modality import modal_inputs

TOL = 1e-4
# (case, registry id); "gemma-7b-hd256" is Gemma's smoke config at the
# published head_dim 256
CASES = ("pipedec-target", "qwen2.5-32b", "gemma-7b-hd256",
         "deepseek-v2-236b", "internvl2-26b", "whisper-base",
         "recurrentgemma-9b")
WINDOWS = (0, 3)
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_cfg(case: str):
    """The case's JAX smoke config."""
    if case == "gemma-7b-hd256":
        return dataclasses.replace(jreg.get_config("gemma-7b", smoke=True),
                                   head_dim=256)
    return jreg.get_config(case, smoke=True)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """{"case", "cfg", "jcfg", "params", "model", "jkw", "kw"}: the
    modality keywords of the JAX steps (prefix rows repeated per batch row
    by the caller) and of the port's."""
    jcfg = case_cfg(request.param)
    params = family_params(jcfg, seed=11)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    jkw, kw = {}, {}
    if cfg.is_encdec or cfg.prefix_tokens:
        x = modal_inputs(cfg, seed=12)
        if cfg.is_encdec:
            jkw["enc_out"] = jenc.encode(
                jax.tree.map(jnp.asarray, params["encoder"]), jcfg,
                jnp.asarray(x))
            kw["enc_out"] = encdec.encode(model.encoder, cfg, x)
        else:
            jkw["prefix_embeds"], kw["prefix_embeds"] = jnp.asarray(x), x
    return {"case": request.param, "cfg": cfg, "jcfg": jcfg,
            "params": params, "model": model, "jkw": jkw, "kw": kw}


def _cl(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_resolve_windows_replaces_every_attention_layer():
    """-1 keeps each layer's window (RecurrentGemma's local layers 16,
    every other layer 0); >= 0 replaces all of them, 0 included."""
    model = tf.Transformer(port_cfg(case_cfg("recurrentgemma-9b")), "meta")
    assert tf.resolve_windows(model.cfg) == model.windows == [
        16 if k == "local" else 0 for k in tf.layer_kinds(model.cfg)]
    assert 16 in model.windows
    for wo in (0, 3, 4096):
        assert tf.resolve_windows(model.cfg, wo) == [wo] * len(model.windows)
    assert model.windows == tf.layer_windows(model.cfg)


@pytest.mark.parametrize("window", WINDOWS)
def test_forward_prefill_decode_tree_match_jax(case, window):
    """``forward``, prefill of 2 rows of 6 tokens (after the prefix; over
    the encoder output), 3 decode steps, then a tree layer with per-row
    prefixes (not for RecurrentGemma: it speculates in chain mode), each
    with the override, against the JAX step functions with the same."""
    cfg, jcfg, model = case["cfg"], case["jcfg"], case["model"]
    jp = jax.tree.map(jnp.asarray, case["params"])
    jkw, kw = case["jkw"], case["kw"]
    wo = {"window_override": window}
    rng = np.random.default_rng(20 + window)
    b, s, n, tcap = 2, 6, 4, 13
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jrep = {k: (jnp.repeat(v, b, 0) if k == "prefix_embeds" else v)
            for k, v in jkw.items()}
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(tokens), **jrep, **wo)
    with torch.no_grad():
        got = tf.forward(model, tokens, **kw, **wo)
    _cl(got, want)
    enc = {k: v for k, v in jkw.items() if k == "enc_out"}
    tenc = ({"cross_kv": tf.encode_cross_kv(model, kw["enc_out"])}
            if "enc_out" in kw else {})
    pre = {k: v for k, v in kw.items() if k == "prefix_embeds"}
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(tokens),
                         jtf.init_cache(jcfg, b, MAX_LEN), **jrep, **wo)
    tl, tc = tf.prefill(model, tokens, tf.init_cache(cfg, b, MAX_LEN,
                                                     device="cpu"),
                        **pre, **tenc, **wo)
    _cl(tl, jl)
    ln = s + cfg.prefix_tokens
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc, ln + step,
                                 **enc, **wo)
        tl, tc = tf.decode_step(model, tok, tc, ln + step, **tenc, **wo)
        _cl(tl, jl)
    if tf.is_recurrent(cfg):
        return
    ln += 3
    cache_len = np.array([ln, ln - 2], np.int32)
    nt = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    pos = (cache_len[:, None] + rng.integers(0, 3, (b, n))).astype(np.int32)
    mask = rng.random((b, n, tcap)) < 0.5
    mask[:, :, 0] = True
    jl, _ = jtf.tree_verify_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos),
                                 jnp.asarray(mask), jc,
                                 jnp.asarray(cache_len),
                                 jtf.init_tree_caches(jcfg, b, tcap),
                                 jnp.asarray([0, 3], np.int32), **enc, **wo)
    tl, _ = tf.tree_verify_step(model, nt, pos, mask, tc, cache_len,
                                tf.init_tree_caches(cfg, b, tcap,
                                                    device="cpu"),
                                [0, 3], **tenc, **wo)
    _cl(tl, jl)
