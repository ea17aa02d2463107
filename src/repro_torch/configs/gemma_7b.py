"""gemma-7b [arXiv:2403.08295] — dense, GeGLU, head_dim=256, tied embeddings.

28L, d_model 3072, 16H (GQA kv=16), d_ff 24576, vocab 256000.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000,
    mlp_variant="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=64, d_ff=512, vocab_size=512,
    mlp_variant="geglu", tie_embeddings=True,
)
