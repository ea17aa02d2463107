"""Encoder tower of the encoder-decoder family (Whisper): the port of the
JAX package's ``repro/models/encdec.py``.

The modality front (mel spectrogram and convolutions) is a stub
(``models.frontends``): the encoder takes frame embeddings [B, T, d].
Each layer is pre-norm bidirectional self-attention (RoPE on positions
0..T-1, no mask; the decoder's head counts) then a pre-norm GELU MLP of
width ``encoder.d_ff`` (the decoder's ``d_ff`` when 0), and a final norm
closes the tower.  The attention goes through the flash kernel with no
causal bound and every key valid (``ops.full_attention``; its plain
version on the CPU), where the reference attends in plain ``jnp``: the
same function.

The reference stacks the layers' leaves along a leading axis
(``{"layers": ..., "final_norm": ...}``); here each layer is an
``EncoderLayer`` and the weight bridge stacks and unstacks them.
"""
from __future__ import annotations

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


@torch.no_grad()
def encode(encoder: Encoder, cfg: ModelConfig, frames) -> torch.Tensor:
    """Frame embeddings [B, T, d] -> the encoder output [B, T, d]."""
    dev = encoder.final_norm.scale.device
    x = torch.as_tensor(frames, device=dev).float()
    b, t = x.shape[:2]
    positions = torch.arange(t, device=dev).expand(b, t)
    for layer in encoder.layers:
        x = x + attn.attn_bidir(layer.attn, cfg, layer.norm1(x), positions)
        x = x + mlp(layer.mlp, layer.norm2(x))
    return encoder.final_norm(x)
