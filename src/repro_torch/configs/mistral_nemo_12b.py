"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: dense GQA,
head_dim 128 (q-proj 5120->4096), 128k context. Full attention ->
long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", vocab_size=131_072,
    d_model=5_120, n_layers=40, n_heads=32, n_kv_heads=8, d_ff=14_336,
    head_dim=128, rope_base=1_000_000.0,
    notes="128k ctx; head_dim 128 != d_model/n_heads",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=96,
                         compute_dtype="float32")
