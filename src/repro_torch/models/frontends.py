"""Stub modality frontends, as in the JAX package's
``repro/models/frontends.py``: the audio front of Whisper (mel spectrogram
and two convolutions) and the vision tower of a VLM (InternViT and its
projector) are not implemented.  These helpers give their outputs' shapes
and deterministic embeddings of those shapes, so the models run end to
end: frame embeddings [B, max_source_positions, d] for the encoder and
patch embeddings [B, prefix_tokens, d] for the decoder's prefix.

The draws come from a seeded ``torch.Generator`` (normal times 0.02, the
reference's scale); they cannot replay ``jax.random``, so the two
packages are compared on the same numpy arrays, never on these draws.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


def audio_frames_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of the encoder's frame embeddings."""
    return (batch, cfg.encoder.max_source_positions, cfg.d_model), \
        torch.float32


def vision_prefix_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of a VLM's prefix patch embeddings."""
    return (batch, cfg.prefix_tokens, cfg.d_model), torch.float32


def _stub(shape, seed: int, device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev) * 0.02


def stub_audio_frames(cfg: ModelConfig, batch: int, seed: int = 0, *,
                      device: DeviceLike = None) -> torch.Tensor:
    """Frame embeddings [batch, max_source_positions, d] drawn from
    ``seed`` on ``device`` (CUDA unless the caller asks for the CPU)."""
    return _stub(audio_frames_spec(cfg, batch)[0], seed, device)


def stub_vision_prefix(cfg: ModelConfig, batch: int, seed: int = 0, *,
                       device: DeviceLike = None) -> torch.Tensor:
    """Prefix patch embeddings [batch, prefix_tokens, d] drawn from
    ``seed`` on ``device``."""
    return _stub(vision_prefix_spec(cfg, batch)[0], seed, device)
