"""RWKV6-3B "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay.
SwiftKV attention inapplicable (no KV cache / softmax) — DESIGN.md §4.
O(1)-state decode -> long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", vocab_size=65_536, d_model=2_560,
    n_layers=32, n_heads=40, n_kv_heads=40, d_ff=8_960, rwkv_head_dim=64,
    rotary_frac=0.0, sub_quadratic=True,
    notes="attention-free; wkv state [H,64,64] per layer",
)

REDUCED = CONFIG.replace(vocab_size=503, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, d_ff=96, rwkv_head_dim=16,
                         compute_dtype="float32")
