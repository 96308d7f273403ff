"""LLaMA2-7B — the paper's primary evaluation model (§V, Tables I/III)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense", vocab_size=32_000, d_model=4_096,
    n_layers=32, n_heads=32, n_kv_heads=32, d_ff=11_008, head_dim=128,
    notes="paper model; 32-head MHA, one head per SKV processor",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=16, d_ff=96,
                         compute_dtype="float32")
