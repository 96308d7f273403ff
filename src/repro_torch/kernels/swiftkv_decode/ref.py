"""Plain PyTorch version of the SwiftKV decode kernel: the dense two-pass
softmax oracle (materializes scores — exactly what the kernel avoids),
extended to int8 caches with per-position scales."""
from __future__ import annotations

import torch

from repro_torch.core.swiftkv import dequantize_cache, softmax_attention_reference


def swiftkv_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor, *,
                       window: int | None = None, scale: float | None = None,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B]; k_scale /
    v_scale: optional [B, Hkv, S] scales of an int8 cache -> [B, Hq, D]."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale)
        v_cache = dequantize_cache(v_cache, v_scale)
    out = softmax_attention_reference(q.reshape(b, hkv, hq // hkv, d),
                                      k_cache, v_cache, lengths,
                                      window=window, scale=scale)
    return out.reshape(b, hq, d)
