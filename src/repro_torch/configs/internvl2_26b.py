"""internvl2-26b [arXiv:2404.16821] — VLM: InternViT-6B (stub) + InternLM2-20B.

Language backbone: 48L, d_model 6144, 48H (GQA kv=8), d_ff 16384,
vocab 92553.  The vision tower + MLP projector are stubbed; the LM consumes
256 prefix patch embeddings per image (448px / patch 14, pixel-shuffle 0.5).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    mlp_variant="swiglu", prefix_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
    d_ff=384, vocab_size=512,
    mlp_variant="swiglu", prefix_tokens=8,
)
