"""The paper's own experiment pair, at its published widths.

The paper accelerates LLaMA-3.1-70B (80L, d 8192, 64H kv8, ff 28672,
vocab 128256) with a LLaMA-3.2-1B draft (16L, d 2048, 32H kv8, ff 8192).
``TARGET``/``DRAFT`` keep the full-scale shapes; ``*_SMOKE`` are the small
pair the tests and the smoke CLI run (shared vocab, as speculative decoding
requires).  The widths are the JAX package's, ``rope_theta`` included.
"""
from repro_torch.models.config import ModelConfig

TARGET = ModelConfig(
    name="llama3.1-70b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, mlp_variant="swiglu",
)

DRAFT = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, mlp_variant="swiglu", tie_embeddings=True,
)

TARGET_SMOKE = ModelConfig(
    name="pipedec-target-smoke", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=704, vocab_size=512, mlp_variant="swiglu",
)

DRAFT_SMOKE = ModelConfig(
    name="pipedec-draft-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=352, vocab_size=512, mlp_variant="swiglu", tie_embeddings=True,
)
