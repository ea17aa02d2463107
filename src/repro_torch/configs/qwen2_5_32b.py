"""qwen2.5-32b [hf:Qwen/Qwen2.5-0.5B family] — dense, GQA kv=8, QKV bias.

64L, d_model 5120, 40H (GQA kv=8), d_ff 27648, vocab 152064.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    mlp_variant="swiglu", qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=160, num_heads=5, num_kv_heads=1,
    d_ff=448, vocab_size=512,
    mlp_variant="swiglu", qkv_bias=True,
)
