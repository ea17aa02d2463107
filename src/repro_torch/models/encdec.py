"""Encoder tower of the encoder-decoder family (Whisper): the port of the
JAX package's ``repro/models/encdec.py``.

The modality front (mel spectrogram and convolutions) is a stub
(``models.frontends``): the encoder takes frame embeddings [B, T, d].
Each layer is pre-norm bidirectional self-attention (RoPE on positions
0..T-1, no mask; the decoder's head counts) then a pre-norm GELU MLP of
width ``encoder.d_ff`` (the decoder's ``d_ff`` when 0), and a final norm
closes the tower.  Serving attends through the flash kernel with no
causal bound and every key valid (``ops.full_attention``; its plain
version on the CPU), where the reference attends in plain ``jnp``: the
same function.  Training (``encode(train=True)``) attends in plain
PyTorch under autograd, as the reference does under ``jax.grad``.

The reference stacks the layers' leaves along a leading axis
(``{"layers": ..., "final_norm": ...}``); here each layer is an
``EncoderLayer`` and the weight bridge stacks and unstacks them.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, RMSNorm, mlp


class EncoderLayer(nn.Module):
    """norm1, attn (GQA weights), norm2, mlp (GELU)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg.d_model, cfg.encoder.d_ff or cfg.d_ff, device,
                       variant="gelu")

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw the layer's weights from ``gen``."""
        self.norm1.reset_parameters()
        self.attn.reset_parameters(gen)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(gen)


class Encoder(nn.Module):
    """``encoder.num_layers`` ``EncoderLayer``s and a final norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.encoder.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every weight from ``gen``."""
        for layer in self.layers:
            layer.reset_parameters(gen)
        self.final_norm.reset_parameters()


def encode(encoder: Encoder, cfg: ModelConfig, frames, *,
           train: bool = False) -> torch.Tensor:
    """Frame embeddings [B, T, d] -> the encoder output [B, T, d]: under
    ``no_grad`` through the flash kernel, or, with ``train``, under
    autograd with the attention in plain PyTorch (the kernel has no
    backward), so a loss over the output reaches the encoder's weights."""
    scale = encoder.final_norm.scale
    x = torch.as_tensor(frames, device=scale.device).to(scale.dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=scale.device).expand(b, t)
    with contextlib.nullcontext() if train else torch.no_grad():
        for layer in encoder.layers:
            x = x + attn.attn_bidir(layer.attn, cfg, layer.norm1(x),
                                    positions, train=train)
            x = x + mlp(layer.mlp, layer.norm2(x))
        return encoder.final_norm(x)
