"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B family] — dense, near-MHA GQA, QKV bias.

64L, d_model 5120, 40H (GQA kv=40), d_ff 27392, vocab 152064.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    mlp_variant="swiglu", qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    num_layers=2, d_model=160, num_heads=5, num_kv_heads=5,
    d_ff=448, vocab_size=512,
    mlp_variant="swiglu", qkv_bias=True,
)
