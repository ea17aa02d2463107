"""Model configuration covering every assigned architecture family.

One frozen dataclass describes dense / MoE / MLA / SSM / hybrid (RG-LRU) /
encoder-decoder (audio) / VLM backbones.  Configs for the ten assigned
architectures live in ``repro.configs.<id>`` and are plain instances of
:class:`ModelConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (token-choice top-k routing)."""

    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # which decoder layers are MoE; ``first_dense`` dense layers at the bottom
    # (Moonlight/DeepSeek style) keep a plain MLP.
    first_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# hybrid block-pattern characters -> sub-layer kinds (single source of
# truth for ModelConfig.block_kind and transformer.unit_kinds); any other
# character means local attention
PATTERN_KINDS = {"r": "rglru", "s": "ssm"}


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU + local attention hybrid."""

    lru_width: int = 0  # 0 => d_model
    d_conv: int = 4
    # repeating block pattern: 'r' = RG-LRU recurrent, 's' = Mamba-2 SSD
    # (requires ``ModelConfig.ssm``; Jamba-style attn+ssm hybrids),
    # anything else = local attention.
    pattern: str = "rra"
    window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (whisper) / VLM prefix settings."""

    num_layers: int = 0
    num_heads: int = 0
    d_ff: int = 0
    max_source_positions: int = 1500  # audio frames / vision patches


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 => d_model // num_heads
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq_len: int = 8192

    # attention variant for long_500k: 0 => full causal attention.
    sliding_window: int = 0

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None

    # VLM: number of prefix embedding slots fed by the (stub) vision frontend.
    prefix_tokens: int = 0

    dtype: str = "float32"

    # serving quantization: "" = fp32 reference path (bit-pinned),
    # "int8" = per-out-channel int8 weights + per-row int8 KV cache
    # (ModelBundle.quantize() sets this; dense attention families only).
    quant: str = ""

    # ---- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None and self.family == "audio"

    def block_kind(self, layer: int) -> str:
        """'attn' | 'ssm' | 'rglru' | 'local' for decoder layer ``layer``."""
        if self.family == "ssm":
            return "ssm"
        if self.rglru is not None:
            c = self.rglru.pattern[layer % len(self.rglru.pattern)]
            return PATTERN_KINDS.get(c, "local")
        return "attn"

    def layer_is_moe(self, layer: int) -> bool:
        return self.moe is not None and layer >= self.moe.first_dense

    # rough parameter counts (for roofline MODEL_FLOPS = 6·N·D) -------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        n_emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = n_emb
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            if kind == "ssm":
                s = self.ssm
                di = s.d_inner(d)
                total += d * (2 * di + 2 * s.d_state + s.num_heads(d))
                total += di * s.d_conv + di * d + di  # conv, out_proj, norm-ish
                continue
            if kind == "rglru":
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * d + 3 * w * w // w * w  # in/out + gates
            else:  # attention
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * (self.num_heads * qd)  # q
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd  # q
                    total += 2 * d * self.num_kv_heads * hd  # k, v
                    total += self.num_heads * hd * d  # o
            # MLP / MoE
            if self.layer_is_moe(layer):
                mo = self.moe
                per_expert = 3 * d * mo.d_ff_expert
                shared = mo.num_shared_experts * per_expert
                if active_only:
                    total += shared + mo.experts_per_token * per_expert
                else:
                    total += shared + mo.num_experts * per_expert
                total += d * mo.num_experts  # router
            elif kind in ("attn", "local", "rglru"):
                mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                total += mult * d * ff
        return total
