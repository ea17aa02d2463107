"""The AdamW train step of the port.

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
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update


def _check(model: tf.Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def batch_loss(model: tf.Transformer, batch: dict, *, remat: bool = True):
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
                      enc_out=enc_out, remat=remat)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, remat: bool = True):
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
        loss = batch_loss(model, batch, remat=remat)
        loss.backward()
        _, opt_state, metrics = adamw_update(
            opt_cfg, params, [p.grad for p in params], opt_state)
        for p in params:
            p.grad = None
        return opt_state, {"loss": loss.detach(), **metrics}

    return train_step
