"""ChatGLM-6B — the paper's second evaluation model (Table III). Partial
rotary (half the head dims)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm-6b", family="dense", vocab_size=130_528, d_model=4_096,
    n_layers=28, n_heads=32, n_kv_heads=32, d_ff=16_384, head_dim=128,
    rotary_frac=0.5, act="gelu", gated_mlp=False,
    notes="paper model; partial rotary; plain GELU FFN",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=16, d_ff=96,
                         compute_dtype="float32")
