"""The modality families of the port against the JAX package on bridged
weights, at their smoke sizes: InternVL2 (a vision prefix of patch
embeddings before the prompt) and Whisper (an encoder, and a
cross-attention sub-layer in each decoder layer).

The JAX parameter pytree comes from the JAX package's ``init_model``,
with numpy noise on the norm scales (the reference draws ones); the
prefix and the frames are numpy arrays from a seed, fed to both packages
(the stub frontends draw from ``jax.random`` and a ``torch.Generator``,
which cannot replay each other).  Tolerances: the encoder output within
1e-5, the cross-attention and the logits of forward, prefill, decode and
tree verification within 1e-4 (fp32 sums in another order, through a
deeper stack); the bridge round trip bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import frontends as jfront
from repro.models import transformer as jtf
from repro_torch.checkpoint import from_jax_params, to_jax_params
from repro_torch.core.speculative import ModelBundle
from repro_torch.models import attention as attn
from repro_torch.models import encdec, frontends
from repro_torch.models import transformer as tf
from test_torch_families import family_params, port_cfg

ENC_TOL, TOL = 1e-5, 1e-4
ARCHS = ("whisper-base", "internvl2-26b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def modal_inputs(cfg, seed: int):
    """The numpy modality input of ``cfg``: frames [1, T, d] for an
    encoder-decoder, a prefix [1, P, d] for a VLM, normal times 0.02."""
    rng = np.random.default_rng(seed)
    n = (cfg.encoder.max_source_positions if cfg.is_encdec
         else cfg.prefix_tokens)
    return (0.02 * rng.normal(size=(1, n, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def modal(request):
    """(port cfg, JAX cfg, numpy params, port model, JAX kwargs, port
    kwargs): the modality keywords of both packages' step functions."""
    jcfg = jreg.get_config(request.param, smoke=True)
    params = family_params(jcfg, seed=7)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    x = modal_inputs(cfg, seed=8)
    if cfg.is_encdec:
        jkw = {"enc_out": jenc.encode(jax.tree.map(jnp.asarray,
                                                   params["encoder"]),
                                      jcfg, jnp.asarray(x))}
        kw = {"enc_out": encdec.encode(model.encoder, cfg, x)}
    else:
        jkw = {"prefix_embeds": jnp.asarray(x)}
        kw = {"prefix_embeds": torch.as_tensor(x)}
    return cfg, jcfg, params, model, jkw, kw


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_encoder_matches_jax():
    jcfg = jreg.get_config("whisper-base", smoke=True)
    params = family_params(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    frames = np.concatenate([modal_inputs(cfg, s) for s in (1, 2)])
    want = jenc.encode(jax.tree.map(jnp.asarray, params["encoder"]), jcfg,
                       jnp.asarray(frames))
    got = encdec.encode(model.encoder, cfg, frames)
    assert got.shape == (2, cfg.encoder.max_source_positions, cfg.d_model)
    _close(got, want, ENC_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_cross_attention_matches_jax(train):
    """Layer 0's cross-attention of 3 rows over one encoder output (a
    size-1 K/V batch, as a SpecPipe-DB bucket reads it) against the JAX
    ``cross_attn_forward`` over the K/V repeated per row; through the
    flash kernel's plain twin, and the training form."""
    jcfg = jreg.get_config("whisper-base", smoke=True)
    params = family_params(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32)
    enc = modal_inputs(cfg, 4)
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      params["stack"][0]["cross"])
    jk, jv = jattn.encode_cross_kv(jp, jcfg, jnp.asarray(enc))
    want = jattn.cross_attn_forward(jp, jcfg, jnp.asarray(x),
                                    (jnp.repeat(jk, 3, 0),
                                     jnp.repeat(jv, 3, 0)))
    p = model.layers[0].cross
    kv = attn.encode_cross_kv(p, cfg, torch.as_tensor(enc))
    _close(kv[0], jk, ENC_TOL)
    with torch.no_grad():
        got = attn.cross_attn_forward(p, cfg, torch.as_tensor(x), kv,
                                      train=train)
    _close(got, want, ENC_TOL)


def test_forward_and_loss_match_jax(modal):
    cfg, jcfg, params, model, jkw, kw = modal
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(tokens), **jkw)
    with torch.no_grad():
        got = tf.forward(model, tokens, **kw)
        loss = tf.loss_fn(model, tokens, labels, ce_chunk=4, **kw)
    assert got.shape == (1, 7 + cfg.prefix_tokens, cfg.vocab_size)
    _close(got, want)
    _close(loss, jtf.loss_fn(jp, jcfg, jnp.asarray(tokens),
                             jnp.asarray(labels), ce_chunk=4, **jkw), 1e-5)


def test_prefill_decode_tree_logits_match_jax(modal):
    """Prefill (after the prefix; over the encoder output), three decode
    steps, then a tree layer on 2 rows with per-row prefixes and a padded
    row: logits against the JAX step functions."""
    cfg, jcfg, params, model, jkw, kw = modal
    jp = jax.tree.map(jnp.asarray, params)
    enc = {k: v for k, v in jkw.items() if k == "enc_out"}
    tenc = ({"cross_kv": tf.encode_cross_kv(model, kw["enc_out"])}
            if "enc_out" in kw else {})
    step_kw = {k: v for k, v in kw.items() if k == "prefix_embeds"}
    rng = np.random.default_rng(6)
    b, s, max_len, n, tcap = 2, 6, 32, 4, 13
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(tokens),
                         jtf.init_cache(jcfg, b, max_len),
                         **{k: (jnp.repeat(v, b, 0) if k == "prefix_embeds"
                                else v) for k, v in jkw.items()})
    tc = tf.init_cache(cfg, b, max_len, device="cpu")
    tl, tc = tf.prefill(model, tokens, tc, **step_kw, **tenc)
    _close(tl, jl)
    ln = s + cfg.prefix_tokens
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc, ln + step,
                                 **enc)
        tl, tc = tf.decode_step(model, tok, tc, ln + step, **tenc)
        _close(tl, jl)
    ln += 3
    jtc = jtf.init_tree_caches(jcfg, b, tcap)
    ttc = tf.init_tree_caches(cfg, b, tcap, device="cpu")
    cache_len = np.array([ln, ln - 2], np.int32)
    nt = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    pos = (cache_len[:, None] + rng.integers(0, 3, (b, n))).astype(np.int32)
    mask = rng.random((b, n, tcap)) < 0.5
    mask[:, :, 0] = True
    mask[1, -1] = False
    jl, _ = jtf.tree_verify_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos),
                                 jnp.asarray(mask), jc,
                                 jnp.asarray(cache_len), jtc,
                                 jnp.asarray([0, 3], np.int32), **enc)
    tl, _ = tf.tree_verify_step(model, nt, pos, mask, tc, cache_len, ttc,
                                [0, 3], **tenc)
    _close(tl, jl)


def test_cross_kv_once_equals_per_call():
    """The cross K/V computed once (``encode_cross_kv``; a bundle keeps
    exactly these) give, in prefill, decode and a prompt streamed in
    chunks, the logits of ``forward``, which projects the encoder output
    in each call and attends in plain PyTorch."""
    cfg = port_cfg(jreg.get_config("whisper-base", smoke=True))
    model = tf.init_model(cfg, seed=1, device="cpu")
    enc = encdec.encode(model.encoder, cfg, modal_inputs(cfg, 9))
    ckv = tf.encode_cross_kv(model, enc)
    kept = ModelBundle(model, enc_out=enc).cross_kv
    assert all(torch.equal(a, b) for pa, pb in zip(kept, ckv)
               for a, b in zip(pa, pb))
    tokens = np.arange(9)[None] * 7 % cfg.vocab_size
    with torch.no_grad():
        want = tf.forward(model, tokens, enc_out=enc)
    c = tf.init_cache(cfg, 1, 16, device="cpu")
    lp, c = tf.prefill(model, tokens[:, :8], c, cross_kv=ckv)
    _close(lp, want[:, 7], 1e-5)
    ld, c = tf.decode_step(model, tokens[0, 8:], c, 8, cross_kv=ckv)
    _close(ld, want[:, 8], 1e-5)
    c = tf.init_cache(cfg, 1, 16, device="cpu")
    for start in (0, 4):
        lc, c = tf.prefill_chunk(model, tokens[:, start:start + 4], c,
                                 [start], cross_kv=ckv)
        _close(lc, want[:, start:start + 4], 1e-5)


def test_bridge_round_trip_bit_for_bit(modal):
    cfg, jcfg, params, model, _, _ = modal
    back = to_jax_params(model)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {p for p, _ in want}
    for path, w in want:
        np.testing.assert_array_equal(got[path], np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
    assert ("encoder" in back) == cfg.is_encdec
    if cfg.is_encdec:
        assert "cross" in back["stack"][0] and "cross_norm" in back["stack"][0]
        broken = dict(params)
        del broken["encoder"]
        with pytest.raises(ValueError, match="encoder"):
            from_jax_params(cfg, broken, device="cpu")
        bad = jax.tree.map(lambda t: t, params)
        bad["encoder"]["layers"]["attn"]["extra"] = \
            bad["encoder"]["layers"]["attn"]["w_o"]
        with pytest.raises(ValueError, match="extra"):
            from_jax_params(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_frontends_shapes_and_seeds(arch):
    """The stubs' shapes and dtypes equal the JAX specs'; a seed gives the
    same draw twice, another seed another draw."""
    cfg = port_cfg(jreg.get_config(arch, smoke=True))
    if cfg.is_encdec:
        spec, stub = frontends.audio_frames_spec, frontends.stub_audio_frames
        jspec = jfront.audio_frames_spec(cfg, 2)
    else:
        spec, stub = frontends.vision_prefix_spec, frontends.stub_vision_prefix
        jspec = jfront.vision_prefix_spec(cfg, 2)
    shape, dtype = spec(cfg, 2)
    assert shape == jspec.shape and dtype == torch.float32
    a, b = (stub(cfg, 2, seed=s, device="cpu") for s in (0, 0))
    assert a.shape == shape and a.dtype == dtype and torch.equal(a, b)
    assert not torch.equal(a, stub(cfg, 2, seed=1, device="cpu"))
    assert 0.01 < float(a.std()) < 0.03
