"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8, d_ff(expert)=1024,
kv=16 (full MHA-style KV). Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", vocab_size=50_304, d_model=2_048,
    n_layers=16, n_heads=16, n_kv_heads=16, d_ff=1_024, head_dim=128,
    n_experts=64, top_k=8, qk_norm=True,
    notes="64e top-8 fine-grained experts; qk-norm per OLMoE",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=16, d_ff=32, n_experts=8,
                         top_k=2, capacity_factor=8.0, compute_dtype="float32")
