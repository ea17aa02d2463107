"""deepseek-v2-236b [arXiv:2405.04434] — MoE + MLA.

60L, d_model 5120, 128H MLA (kv_lora 512, q_lora 1536, nope 128 / rope 64,
v_head 128), expert d_ff 1536, vocab 102400, 160 routed top-6 + 2 shared,
first layer dense (dense d_ff 12288).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    mlp_variant="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, experts_per_token=6, d_ff_expert=1536,
                  num_shared_experts=2, first_dense=1),
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    mlp_variant="swiglu",
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=64,
                  num_shared_experts=2, first_dense=1,
                  capacity_factor=4.0),
)
