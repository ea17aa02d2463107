"""whisper-base [arXiv:2212.04356] — enc-dec audio backbone.

6L encoder + 6L decoder, d_model 512, 8H, d_ff 2048, vocab 51865.
The mel+conv frontend is stubbed (input_specs provide frame embeddings of
shape [B, 1500, 512]); the encoder/decoder towers are fully implemented.
Positional scheme: RoPE on decoder self-attention (uniform with the rest of
the framework; Whisper's learned embeddings are a frontend detail).
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    mlp_variant="gelu",
    encoder=EncoderConfig(num_layers=6, num_heads=8, d_ff=2048,
                          max_source_positions=1500),
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    mlp_variant="gelu",
    encoder=EncoderConfig(num_layers=2, num_heads=4, d_ff=256,
                          max_source_positions=16),
)
