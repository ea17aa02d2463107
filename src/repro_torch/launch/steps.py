"""The AdamW train step of the port.

The JAX package's ``repro/launch/steps.py`` ``make_train_step`` for the
dense, MoE and MLA decoders: the loss (with the MoE router term) and its
gradients under autograd (attention in plain PyTorch, no kernel), then
the weights updated in place.  The modality families (a vision prefix or
an encoder in the batch) and the recurrent families are ROADMAP item 16
and are refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update


def _check(model: tf.Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a configuration the trainer does not train yet: the
    modality families, whose batches carry a vision prefix or encoder
    frames, and the recurrent families (ROADMAP item 16)."""
    tf.check_supported(cfg)
    if cfg.prefix_tokens > 0 or cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: training the modality families (a vision prefix "
            "or an encoder) is ROADMAP item 16")
    if tf.is_recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training the recurrent families (ssm/rglru "
            "sub-layers) is ROADMAP item 16")


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, remat: bool = True):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``: one AdamW
    step on ``batch`` ({"tokens", "labels"} [B,S], numpy or tensors) that
    updates ``model``'s weights in place.  The weights must be trainable
    (``layers.trainable``) and ``opt_state`` made by ``adamw_init`` over
    them, in ``parameters()`` order.  ``metrics`` holds 0-d tensors on the
    model's device: ``loss``, ``grad_norm`` and ``lr``."""
    check_trainable(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model: tf.Transformer, opt_state: dict, batch: dict):
        _check(model, cfg)
        params = list(model.parameters())
        if not all(p.requires_grad for p in params):
            raise ValueError("the weights take no gradient: make them "
                             "trainable (layers.trainable) first")
        for p in params:
            p.grad = None
        loss = tf.loss_fn(model, batch["tokens"], batch["labels"],
                          remat=remat)
        loss.backward()
        _, opt_state, metrics = adamw_update(
            opt_cfg, params, [p.grad for p in params], opt_state)
        for p in params:
            p.grad = None
        return opt_state, {"loss": loss.detach(), **metrics}

    return train_step

