"""mamba2-130m [arXiv:2405.21060] — attention-free SSD (state-space duality).

24L, d_model 768, d_inner 1536 (expand 2), 24 SSD heads (head_dim 64),
d_state 128, vocab 50280, no MLP (d_ff = 0), tied embeddings.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512, tie_embeddings=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
)
