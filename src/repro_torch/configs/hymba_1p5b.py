"""Hymba-1.5B [arXiv:2411.13676]: hybrid layers with parallel attention and
Mamba heads; SWA on the attention branch -> sub-quadratic (long_500k runs)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", vocab_size=32_001, d_model=1_600,
    n_layers=32, n_heads=25, n_kv_heads=5, d_ff=5_504, head_dim=64,
    ssm_state=16, ssm_conv=4, ssm_expand=2, window=1_024,
    sub_quadratic=True,
    notes="parallel attn+mamba heads; SWA window 1024 on the attn branch",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=5,
                         n_kv_heads=5, head_dim=16, d_ff=96, window=32,
                         ssm_state=4, compute_dtype="float32")
