"""Llama-3.2-Vision-90B backbone [hf:meta-llama]: decoder with dedicated
gated cross-attention layers every 5th layer; vision frontend is a stub
(precomputed patch embeddings). Pure full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", vocab_size=128_256,
    d_model=8_192, n_layers=100, n_heads=64, n_kv_heads=8, d_ff=28_672,
    head_dim=128, rope_base=500_000.0, cross_attn_every=5, source_len=1_600,
    notes="100L = 80 self + 20 cross; image embeds stubbed at 1600 tokens",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=5, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=96, source_len=24,
                         compute_dtype="float32")
