"""The window override of the port against the JAX package on bridged
weights, at smoke size: ``prefill_chunk`` (a prompt fed in chunks, as the
ring's lane feeds it) and ``loss_fn`` with every gradient leaf, each with
``window_override``, for the configs of ``test_torch_window.py``.

Tolerances: chunk logits within 1e-4, the last chunk against a one-shot
prefill within 1e-5; the loss within 1e-5 and every gradient leaf within
1e-4 of the compared tensor's largest magnitude (``test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro_torch.checkpoint import from_jax_params
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.models.layers import trainable
from test_torch_families import family_params, port_cfg
from test_torch_train import TOL_FWD, TOL_GRAD, _close, _port_grads, \
    _tree_close
from test_torch_window import MAX_LEN, WINDOWS, _cl, case_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("arch", ["pipedec-target", "gemma-7b-hd256",
                                  "deepseek-v2-236b"])
def test_prefill_chunk_matches_jax(arch, window):
    """A prompt of 2 rows fed in 3 chunks of 4 (rows at their own
    starts) with the override, against the JAX ``prefill_chunk``, and
    the last chunk against a one-shot prefill."""
    jcfg = case_cfg(arch)
    params = family_params(jcfg, seed=13)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    tokens = np.random.default_rng(window).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc = jtf.init_cache(jcfg, 2, MAX_LEN)
    tc = tf.init_cache(cfg, 2, MAX_LEN, device="cpu")
    for start in (0, 4, 8):
        chunk = tokens[:, start:start + 4]
        jl, jc = jtf.prefill_chunk(jp, jcfg, jnp.asarray(chunk), jc,
                                   np.array([start, start], np.int32),
                                   window_override=window)
        tl, tc = tf.prefill_chunk(model, chunk, tc, [start, start],
                                  window_override=window)
        _cl(tl, jl)
    one, _ = tf.prefill(model, tokens, tf.init_cache(cfg, 2, MAX_LEN,
                                                     device="cpu"),
                        window_override=window)
    _cl(tl[:, -1], one, 1e-5)


@pytest.mark.parametrize("arch", ["gemma-7b-hd256", "deepseek-v2-236b",
                                  "internvl2-26b", "whisper-base",
                                  "recurrentgemma-9b"])
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` with a 3-key window over 21 positions (the prefix
    rows; the encoder under autograd) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's loss with the same
    override."""
    jcfg = case_cfg(arch)
    params = family_params(jcfg, seed=14)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    trainable(model)
    rng = np.random.default_rng(15)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 21)),
             "labels": rng.integers(-1, cfg.vocab_size, (2, 21))}
    if cfg.prefix_tokens:
        batch["prefix_embeds"] = (0.02 * rng.normal(
            size=(2, cfg.prefix_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = (0.02 * rng.normal(
            size=(2, cfg.encoder.max_source_positions,
                  cfg.d_model))).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        enc = (jenc.encode(p["encoder"], jcfg, jb["frames"])
               if "frames" in jb else None)
        return jtf.loss_fn(p, jcfg, jb["tokens"], jb["labels"],
                           prefix_embeds=jb.get("prefix_embeds"),
                           enc_out=enc, window_override=3)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    loss = steps.batch_loss(model, batch, remat=False, window_override=3)
    loss.backward()
    _close(loss.item(), float(jl), TOL_FWD)
    _tree_close(_port_grads(model), jg, TOL_GRAD)
    # the override reached the loss: without it the loss differs
    free = steps.batch_loss(model, batch, remat=False)
    assert abs(free.item() - loss.item()) > 1e-6
