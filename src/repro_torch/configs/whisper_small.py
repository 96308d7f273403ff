"""Whisper-small backbone [arXiv:2212.04356]: 12L encoder + 12L decoder,
conv/mel frontend STUBBED (precomputed frame embeddings, source_len=1500).
Decoder shapes exercise the self-attn KV cache; encoder has no decode step.
Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", vocab_size=51_865, d_model=768,
    n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3_072, head_dim=64,
    act="gelu", gated_mlp=False, encoder_layers=12, source_len=1_500,
    cross_attn_every=1,
    notes="enc-dec; plain GELU MLP; cross-attn in every decoder layer",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=16, d_ff=96, encoder_layers=2,
                         source_len=24, compute_dtype="float32")
