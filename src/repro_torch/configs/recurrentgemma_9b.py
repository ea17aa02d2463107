"""recurrentgemma-9b [arXiv:2402.19427] — Griffin hybrid: RG-LRU + local attn.

38L, d_model 4096, 16H local attention (MQA kv=1), d_ff 12288, vocab 256000,
block pattern recurrent:attention = 2:1 ("rra"), lru width 4096, window 2048.
38 = 12 full "rra" units + 2 trailing recurrent layers.
"""
from repro_torch.models.config import ModelConfig, RGLRUConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    mlp_variant="geglu", tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4, pattern="rra", window=2048),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512,
    mlp_variant="geglu", tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=128, d_conv=4, pattern="rra", window=16),
)
