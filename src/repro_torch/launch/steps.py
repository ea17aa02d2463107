"""The step functions of the port: the AdamW train step, and the
prefill and serving steps the dry run runs.

The JAX package's ``repro/launch/steps.py`` ``make_train_step`` for every
family the port serves: dense, MoE and MLA decoders, a VLM (the batch's
``prefix_embeds`` before the tokens, their rows left out of the loss),
an encoder-decoder (the batch's ``frames`` through the encoder inside
the loss, so the encoder takes gradients; without frames the decoder
skips its cross sub-layers, as the reference does) and the recurrent
families (SSD and RG-LRU in plain PyTorch).  The loss (with the MoE
router term) and its gradients come from autograd, the attention in
plain PyTorch (no kernel: the kernels have no backward); then the
weights are updated in place.  A weight the loss does not reach keeps a
``None`` gradient, which ``adamw_update`` takes as the zero gradient
``jax.grad`` gives it: its moments decay and the weight decay moves it.
int8 weights do not train (``layers.trainable`` refuses them).

``make_prefill_step`` and ``make_serve_step`` are the reference's serving
steps as the dry run (``launch.dryrun``) runs them: a prefill that builds
its own cache, and one decode token against a cache.  Every step takes
the reference's ``window_override`` (``launch.specs.window_override``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update


def _check(model: tf.Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def batch_loss(model: tf.Transformer, batch: dict, *, remat: bool = True,
               window_override: int = -1):
    """The step's loss of ``batch`` ({"tokens", "labels"} [B,S] and,
    when given, "prefix_embeds" [1|B,P,d] and "frames" [B,T,d]) under
    autograd: the reference's ``loss_fn`` call, with the encoder output
    of the frames (``_enc_out``) for an encoder-decoder."""
    cfg = model.cfg
    enc_out = None
    if cfg.is_encdec and batch.get("frames") is not None:
        enc_out = encdec.encode(model.encoder, cfg, batch["frames"],
                                train=True)
    return tf.loss_fn(model, batch["tokens"], batch["labels"],
                      prefix_embeds=batch.get("prefix_embeds"),
                      enc_out=enc_out, remat=remat,
                      window_override=window_override)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, window_override: int = -1, remat: bool = True):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``: one AdamW
    step on ``batch`` (``batch_loss``'s keys, numpy or tensors) that
    updates ``model``'s weights in place.  The weights must be trainable
    (``layers.trainable``) and ``opt_state`` made by ``adamw_init`` over
    them, in ``parameters()`` order.  ``metrics`` holds 0-d tensors on the
    model's device: ``loss``, ``grad_norm`` and ``lr``."""
    tf.check_supported(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model: tf.Transformer, opt_state: dict, batch: dict):
        _check(model, cfg)
        params = list(model.parameters())
        if not all(p.requires_grad for p in params):
            raise ValueError("the weights take no gradient: make them "
                             "trainable (layers.trainable) first")
        for p in params:
            p.grad = None
        loss = batch_loss(model, batch, remat=remat,
                          window_override=window_override)
        loss.backward()
        _, opt_state, metrics = adamw_update(
            opt_cfg, params, [p.grad for p in params], opt_state)
        for p in params:
            p.grad = None
        return opt_state, {"loss": loss.detach(), **metrics}

    return train_step


def _cross_kv(model: tf.Transformer, frames=None, enc_out=None):
    """An encoder-decoder's per-layer cross K/V from ``frames`` (through
    the encoder) or from an encoder output; None otherwise."""
    if not model.cfg.is_encdec or (frames is None and enc_out is None):
        return None
    if enc_out is None:
        enc_out = encdec.encode(model.encoder, model.cfg, frames)
    return tf.encode_cross_kv(model, enc_out)


def make_prefill_step(cfg: ModelConfig, *, window_override: int = -1,
                      max_len: int = 0,
                      cache_dtype: Optional[torch.dtype] = None):
    """``step(model, tokens, prefix_embeds=None, frames=None) -> (logits
    [B,V], cache)``: a prefill that builds its own cache of ``max_len``
    (the prompt's length when 0) plus ``cfg.prefix_tokens`` rows on the
    model's device, its floating leaves in ``cache_dtype`` when given (as
    the reference's step does), so callers never allocate one."""
    tf.check_supported(cfg)

    def prefill_step(model: tf.Transformer, tokens, prefix_embeds=None,
                     frames=None):
        _check(model, cfg)
        b, s = tokens.shape
        cache = tf.init_cache(cfg, b, (max_len or s) + cfg.prefix_tokens,
                              device=model.device)
        if cache_dtype is not None:
            cache = tf.cast_cache(cache, cache_dtype)
        return tf.prefill(model, tokens, cache, prefix_embeds=prefix_embeds,
                          cross_kv=_cross_kv(model, frames),
                          window_override=window_override)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, window_override: int = -1):
    """``step(model, token, cache, cache_len, enc_out=None) -> (logits
    [B,V], cache)``: one new token per sequence against the cache, at
    ``cache_len`` (the reference's serving step)."""
    tf.check_supported(cfg)

    def serve_step(model: tf.Transformer, token, cache, cache_len,
                   enc_out=None):
        _check(model, cfg)
        return tf.decode_step(model, token, cache, cache_len,
                              cross_kv=_cross_kv(model, enc_out=enc_out),
                              window_override=window_override)

    return serve_step
