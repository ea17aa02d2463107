"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

DeepSeek-V3-style MoE: 48L, d_model 2048, 16H (GQA kv=16), expert d_ff 1408,
vocab 163840, 64 routed experts top-6 + 2 shared, first layer dense
(dense d_ff 11264 per the model card; the assignment's d_ff=1408 is the
per-expert width).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=11264, vocab_size=163840,
    mlp_variant="swiglu",
    moe=MoEConfig(num_experts=64, experts_per_token=6, d_ff_expert=1408,
                  num_shared_experts=2, first_dense=1),
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=352, vocab_size=512,
    mlp_variant="swiglu",
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=88,
                  num_shared_experts=2, first_dense=1,
                  capacity_factor=4.0),
)
