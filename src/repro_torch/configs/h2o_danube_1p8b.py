"""H2O-Danube-1.8B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention -> sub-quadratic (long_500k runs with the window)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense", vocab_size=32_000, d_model=2_560,
    n_layers=24, n_heads=32, n_kv_heads=8, d_ff=6_912, head_dim=80,
    window=4_096, sub_quadratic=True,
    notes="SWA window 4096",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=96, window=32,
                         compute_dtype="float32")
