"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense GQA (kv=8) with per-head qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense", vocab_size=151_936, d_model=4_096,
    n_layers=36, n_heads=32, n_kv_heads=8, d_ff=12_288, head_dim=128,
    qk_norm=True, rope_base=1_000_000.0,
    notes="qk_norm; GQA 32/8",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=96,
                         compute_dtype="float32")
