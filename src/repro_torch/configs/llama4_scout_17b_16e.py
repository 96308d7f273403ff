"""Llama-4-Scout-17B-16E [hf:meta-llama]: MoE 16 experts top-1 (early
fusion). Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", vocab_size=202_048,
    d_model=5_120, n_layers=48, n_heads=40, n_kv_heads=8, d_ff=8_192,
    head_dim=128, rope_base=500_000.0, n_experts=16, top_k=1,
    notes="MoE 16e top-1; ~17B active / ~109B total",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=96, n_experts=4,
                         top_k=1, capacity_factor=8.0, compute_dtype="float32")
