"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16H (GQA kv=16), expert d_ff 1408, vocab 151936,
60 routed experts top-4 + 4 shared (shared width 4x1408 = 5632).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=5632, vocab_size=151936,
    mlp_variant="swiglu", qkv_bias=True,
    moe=MoEConfig(num_experts=60, experts_per_token=4, d_ff_expert=1408,
                  num_shared_experts=4, first_dense=0),
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=352, vocab_size=512,
    mlp_variant="swiglu", qkv_bias=True,
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=88,
                  num_shared_experts=2, first_dense=0,
                  capacity_factor=4.0),
)
