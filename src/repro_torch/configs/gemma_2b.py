"""Gemma-2B [arXiv:2403.08295]: MQA (kv=1), GeGLU, head_dim=256. The MQA
decode shares ONE KV-cache scan across all 8 query heads (DESIGN.md §4).
Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", vocab_size=256_000, d_model=2_048,
    n_layers=18, n_heads=8, n_kv_heads=1, d_ff=16_384, head_dim=256,
    act="gelu", gated_mlp=True, tie_embeddings=True,
    notes="MQA; GeGLU; tied embeddings",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=1, head_dim=16, d_ff=128,
                         compute_dtype="float32")
