"""The port's training path against the JAX package's, on bridged weights.

Weights are drawn with numpy (the JAX parameter pytree) and carried into
the port by ``checkpoint.bridge``; both packages then see the same numpy
tokens and labels.  Tolerances, each relative to the compared tensor's
largest magnitude: logits and loss 1e-5 (fp32 sums in another order);
every gradient leaf 1e-4 (the backward sums over the batch, the sequence
and, for the tied table, both uses); ``remat`` on against off 1e-6; the
losses of 3 AdamW steps 1e-4 (each step's update feeds the next forward,
and Adam's first steps are close to sign(g), which amplifies fp32
differences of small gradients).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_pytree as jax_load_pytree
from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (from_jax_params, load_pytree,
                                    save_pytree, to_jax_params)
from repro_torch.configs import pipedec_pair
from repro_torch.core.speculative import ModelBundle
from repro_torch.data import (ByteCorpus, DataConfig, batch_iterator,
                              synthetic_corpus)
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import trainable
from repro_torch.optim import AdamWConfig, adamw_init

TOL_FWD, TOL_GRAD, TOL_REMAT, TOL_STEPS = 1e-5, 1e-4, 1e-6, 1e-4

UNTIED = ModelConfig(name="t-untied", family="dense", num_layers=3,
                     d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                     vocab_size=300)
TIED = dataclasses.replace(UNTIED, name="t-tied", num_layers=2,
                           tie_embeddings=True)
CONFIGS = {"tied": TIED, "untied": UNTIED}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(cfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def numpy_params(cfg, seed: int):
    """A JAX dense-model parameter pytree drawn with numpy (layers stacked
    on a leading axis), norm scales included."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    n_l, ff, vocab = cfg.num_layers, cfg.d_ff, cfg.vocab_size

    def w(*shape, fan_in):
        return (rng.normal(size=(n_l, *shape)) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(*shape):
        return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)

    def table():
        return (0.02 * rng.normal(size=(vocab, d))).astype(np.float32)

    stack = {"norm1": {"scale": scale(n_l, d)},
             "mixer": {"w_q": w(d, h, hd, fan_in=d),
                       "w_k": w(d, kv, hd, fan_in=d),
                       "w_v": w(d, kv, hd, fan_in=d),
                       "w_o": w(h, hd, d, fan_in=hd)},
             "norm2": {"scale": scale(n_l, d)},
             "ffn": {"w_gate": w(d, ff, fan_in=d), "w_up": w(d, ff, fan_in=d),
                     "w_down": w(ff, d, fan_in=ff)}}
    params = {"embed": {"table": table()}, "final_norm": {"scale": scale(d)},
              "stack": [stack]}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": table()}
    return params


def _close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _tree_close(got, want, tol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for (path, w), g in zip(paths, got_leaves):
        _close(g, w, tol, jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(cfg, numpy params, bridged trainable port model)."""
    cfg = CONFIGS[request.param]
    params = numpy_params(cfg, seed=4)
    model = from_jax_params(cfg, params, device="cpu")
    trainable(model)
    return cfg, params, model


def _batch(cfg, b=2, s=21, seed=0):
    """Tokens and labels [b, s]; s is not a multiple of the CE chunk (8
    below) and some labels are -1 (ignored)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -5:] = -1
    return tokens, labels


def _port_grads(model) -> dict:
    """The models' ``.grad`` tensors as the JAX pytree (``to_jax_params``
    of a copy holding them); a weight the loss did not reach (``.grad``
    None) gives zeros, as ``jax.grad`` does."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            if q.grad is None:
                p.zero_()
            else:
                p.copy_(q.grad)
    return to_jax_params(g)


@pytest.mark.parametrize("window", [-1, 5])
def test_forward_logits_match_jax(pair, window):
    """-1: the config's full causal attention; 5: a sliding window."""
    cfg, params, model = pair
    if window >= 0:
        cfg = dataclasses.replace(cfg, sliding_window=window)
        model = from_jax_params(cfg, params, device="cpu")
    tokens, _ = _batch(cfg)
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, params), jax_cfg(cfg),
                          jnp.asarray(tokens))
    with torch.no_grad():
        got = tf.forward(model, tokens)
    _close(got, want, TOL_FWD)


def test_loss_and_grads_match_jax(pair):
    cfg, params, model = pair
    tokens, labels = _batch(cfg)
    jcfg = jax_cfg(cfg)

    def jloss(p):
        return jtf.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           ce_chunk=8)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = tf.loss_fn(model, tokens, labels, ce_chunk=8)
    loss.backward()
    _close(loss.item(), float(jl), TOL_FWD)
    _tree_close(_port_grads(model), jg, TOL_GRAD)
    model.zero_grad(set_to_none=True)


def test_remat_matches_plain(pair):
    cfg, _, model = pair
    tokens, labels = _batch(cfg, seed=1)
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss = tf.loss_fn(model, tokens, labels, remat=remat, ce_chunk=8)
        loss.backward()
        out.append((loss.item(), _port_grads(model)))
    model.zero_grad(set_to_none=True)
    _close(out[1][0], out[0][0], TOL_REMAT)
    _tree_close(out[1][1], out[0][1], TOL_REMAT)


def test_chunked_ce_matches_full_log_softmax():
    """chunked_ce over chunks equals the mean NLL over B * S of the whole
    logits, padding and -1 labels included, and so does its gradient."""
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 13, 8, 17
    table = torch.tensor(rng.normal(size=(v, d)), dtype=torch.float32,
                         requires_grad=True)
    hidden = torch.tensor(rng.normal(size=(b, s, d)), dtype=torch.float32,
                          requires_grad=True)
    labels = torch.tensor(rng.integers(-1, v, (b, s)))
    got = tf.chunked_ce(table, hidden, labels, chunk=4)
    got.backward()
    g_got = (table.grad.clone(), hidden.grad.clone())
    table.grad = hidden.grad = None
    logp = torch.log_softmax(hidden @ table.T, -1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    want = torch.where(labels >= 0, nll, 0.0).sum() / (b * s)
    want.backward()
    _close(got.item(), want.item(), 1e-6)
    for g, w in zip(g_got, (table.grad, hidden.grad)):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("window", [0, 300])
def test_chunked_causal_attend_matches_jax_and_gqa(window):
    rng = np.random.default_rng(3)
    s = attn.CHUNKED_ATTN_THRESHOLD
    q = rng.normal(size=(1, s, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, s, 1, 8)).astype(np.float32)
    v = rng.normal(size=(1, s, 1, 8)).astype(np.float32)
    want = jattn.chunked_causal_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = attn.chunked_causal_attend(tq, tk, tv, window=window)
    _close(got.detach(), want, TOL_FWD)
    w = torch.tensor(rng.normal(size=got.shape), dtype=torch.float32)
    (got * w).sum().backward()
    g_chunked = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    full = attn.gqa_attend(tq, tk, tv, attn.causal_mask(s, s, 0, window))
    _close(got.detach(), full.detach(), 1e-6)
    (full * w).sum().backward()
    for g, t in zip(g_chunked, (tq, tk, tv)):
        _close(g, t.grad, 1e-5)


@pytest.mark.parametrize("s", [16, attn.CHUNKED_ATTN_THRESHOLD])
def test_attn_train_matches_jax_attn_forward(s):
    """One attention layer on bridged weights below and at the chunked
    threshold, against the JAX package's full-sequence attention."""
    cfg = ModelConfig(name="t-attn", family="dense", num_layers=1,
                      d_model=16, num_heads=2, num_kv_heads=1, d_ff=32,
                      vocab_size=8)
    params = numpy_params(cfg, seed=5)
    mixer = from_jax_params(cfg, params, device="cpu").layers[0].mixer
    jmixer = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          params["stack"][0]["mixer"])
    x = np.random.default_rng(6).normal(size=(1, s, 16)).astype(np.float32)
    pos = np.arange(s)[None]
    want, _ = jattn.attn_forward(jmixer, jax_cfg(cfg), jnp.asarray(x),
                                 jnp.asarray(pos))
    got = attn.attn_train(mixer, cfg, torch.from_numpy(x),
                          torch.from_numpy(pos))
    _close(got.detach(), want, TOL_FWD)


def _byte_batches(seq, batch, n):
    corpus = ByteCorpus(synthetic_corpus(1 << 12, seed=0),
                        DataConfig(seq_len=seq, batch_size=batch, seed=0))
    it = batch_iterator(corpus, epochs=10)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("remat", [False, True])
def test_three_train_steps_match_jax(remat):
    cfg = UNTIED
    params = numpy_params(cfg, seed=7)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_make_train_step(jax_cfg(cfg), JaxAdamWConfig(**kw),
                                        remat=remat))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_adamw_init(jp)
    model = from_jax_params(cfg, params, device="cpu")
    opt = adamw_init(trainable(model))
    tstep = steps.make_train_step(cfg, AdamWConfig(**kw), remat=remat)
    for i, (tokens, labels) in enumerate(_byte_batches(24, 2, 3)):
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(tokens),
                                        "labels": jnp.asarray(labels)})
        opt, tm = tstep(model, opt, {"tokens": tokens, "labels": labels})
        assert all(p.grad is None for p in model.parameters())
        _close(float(tm["loss"]), float(jm["loss"]), TOL_STEPS, f"step {i}")
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]), TOL_STEPS)
        _close(float(tm["lr"]), float(jm["lr"]), 1e-6)
    assert int(opt["step"]) == 3


def test_train_step_refuses_frozen_weights_and_other_config():
    model = tf.init_model(UNTIED, seed=0, device="cpu")
    step = steps.make_train_step(UNTIED, remat=False)
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "labels": np.zeros((1, 4), np.int32)}
    with pytest.raises(ValueError, match="trainable"):
        step(model, adamw_init(list(model.parameters())), batch)
    other = steps.make_train_step(pipedec_pair.DRAFT_SMOKE)
    with pytest.raises(ValueError, match="step built for"):
        other(model, adamw_init(trainable(model)), batch)


def test_int8_model_refuses_training():
    cfg = pipedec_pair.DRAFT_SMOKE
    bundle = ModelBundle(tf.init_model(cfg, seed=0, device="cpu")).quantize()
    with pytest.raises(ValueError, match="int8"):
        trainable(bundle.model)


def test_to_jax_params_round_trip_and_refuses_int8():
    cfg = pipedec_pair.DRAFT_SMOKE
    params = numpy_params(cfg, seed=8)
    got = to_jax_params(from_jax_params(cfg, params, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, got, params)
    q = ModelBundle(from_jax_params(cfg, params, device="cpu")).quantize()
    with pytest.raises(ValueError, match="fp32"):
        to_jax_params(q.model)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """Port ``save_pytree`` -> JAX ``load_pytree``: the same arrays, and
    JAX logits on them equal the port's forward."""
    cfg = UNTIED
    model = from_jax_params(cfg, numpy_params(cfg, seed=9), device="cpu")
    path = str(tmp_path / "port.npz")
    save_pytree(path, {"params": to_jax_params(model), "step": 3,
                       "note": None})
    blob = jax_load_pytree(path)
    assert int(blob["step"]) == 3 and blob["note"] is None
    jax.tree.map(np.testing.assert_array_equal, blob["params"],
                 to_jax_params(model))
    tokens, _ = _batch(cfg, seed=2)
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, blob["params"]),
                          jax_cfg(cfg), jnp.asarray(tokens))
    with torch.no_grad():
        _close(tf.forward(model, tokens), want, TOL_FWD)


def test_jax_checkpoint_loads_in_port_build_bundle(tmp_path):
    """JAX ``save_pytree`` -> port ``build_bundle(ckpt=)``: the same
    weights, bit for bit, and prefill logits within TOL_FWD of JAX."""
    cfg = pipedec_pair.DRAFT_SMOKE
    params = numpy_params(cfg, seed=10)
    path = str(tmp_path / "jax.npz")
    jax_save_pytree(path, {"params": jax.tree.map(jnp.asarray, params)})
    bundle = serve.build_bundle("pipedec-draft", seed=0, ckpt=path,
                                device="cpu")
    jax.tree.map(np.testing.assert_array_equal, to_jax_params(bundle.model),
                 params)
    tokens, _ = _batch(cfg, seed=3)
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, params), jax_cfg(cfg),
                          jnp.asarray(tokens))
    logits, _ = bundle.prefill(tokens, bundle.init_cache(2, 32))
    _close(logits, want[:, -1], TOL_FWD)
    jax.tree.map(np.testing.assert_array_equal,
                 load_pytree(path)["params"], params)


def test_forward_matches_prefill_and_decode():
    """The training forward against the serving path on the same weights:
    prefill's last logits and one ``decode_step`` within TOL_FWD."""
    cfg = pipedec_pair.DRAFT_SMOKE
    model = from_jax_params(cfg, numpy_params(cfg, seed=11), device="cpu")
    tokens, _ = _batch(cfg, s=9, seed=4)
    logits, cache = tf.prefill(model, tokens, tf.init_cache(cfg, 2, 16,
                                                            device="cpu"))
    tok = np.array([3, 5])
    step, _ = tf.decode_step(model, tok, cache, 9)
    with torch.no_grad():
        full = tf.forward(model, np.concatenate([tokens, tok[:, None]], 1))
    _close(logits, full[:, -2], TOL_FWD)
    _close(step, full[:, -1], TOL_FWD)


def test_train_cli_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    model, losses = train.main(["--device", "cpu", "--smoke", "--arch",
                                "pipedec-draft", "--steps", "3", "--batch",
                                "2", "--seq", "32", "--ckpt", path])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "saved checkpoint" in capsys.readouterr().out
    assert not any(p.requires_grad for p in model.parameters())
    blob = jax_load_pytree(path)
    jax.tree.map(np.testing.assert_array_equal, blob["params"],
                 to_jax_params(model))
    bundle = serve.build_bundle("pipedec-draft", seed=0, ckpt=path,
                                device="cpu")
    tokens = np.arange(8)[None]
    with torch.no_grad():
        assert torch.equal(tf.forward(bundle.model, tokens),
                           tf.forward(model, tokens))


def test_train_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(UNTIED, steps=1, batch=1, seq=8)


def test_train_refuses_a_vocab_below_the_bytes():
    small = dataclasses.replace(UNTIED, vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        train.train(small, steps=1, batch=1, seq=8, device="cpu")
