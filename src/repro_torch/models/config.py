"""Model configuration: a field-for-field copy of ``repro.models.config``'s
``ModelConfig`` (the port keeps its own copy so it never imports the JAX
package). ``tests/test_torch_config.py`` holds the two equal."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int | None = None       # default: d_model // n_heads
    act: str = "silu"                 # silu | gelu
    gated_mlp: bool = True            # SwiGLU / GeGLU vs plain MLP
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q,k
    rope_base: float = 10000.0
    rotary_frac: float = 1.0          # fraction of head_dim rotated
    window: int | None = None         # sliding-window attention
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba branch of hybrid archs) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    # --- cross-attention (vlm) / encoder-decoder (audio) ---
    cross_attn_every: int = 0
    encoder_layers: int = 0
    source_len: int = 1500
    # --- numerics / serving ---
    compute_dtype: str = "bfloat16"
    decode_impl: str = "blockwise"    # blockwise | naive | kernel (ported);
                                      # tokenwise | sp wait (ROADMAP §1)
    rope_mode: str = "incremental"    # incremental (paper Eq.11) | direct
    remat_policy: str = "full"
    w4a8_serve: bool = False          # int4-packed projections + int8
                                      # activations and an int8 KV cache
    kv_ring: bool = False
    # --- lowering ---
    unroll_layers: bool = False
    attn_block: int | None = None     # KV-block size of the plain blockwise
                                      # attention loops (default 512)
    # --- capability flags ---
    sub_quadratic: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.resolved_head_dim * self.rotary_frac)
        return rd - (rd % 2)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
