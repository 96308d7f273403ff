"""W4A8 serving-path quantization. Port of ``repro.models.quantized``.

``quantize_params(params)`` walks a params tree and replaces every eligible
projection weight ``name`` (wq/wk/wv/wo and up/gate/down) with the
int4-packed ``name__qp`` + group-scale ``name__qs`` pair that
``layers.linear`` consumes. Stacked ``[L, K, N]`` weights are quantized one
layer at a time on their own device, which bounds the temporary memory of
the clip search to one layer.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import GROUP, quantize_w4

QUANT_KEYS = ("wq", "wk", "wv", "wo", "up", "gate", "down")


def _eligible(name: str, leaf) -> bool:
    return (name in QUANT_KEYS and isinstance(leaf, torch.Tensor)
            and leaf.ndim in (2, 3) and leaf.shape[-1] % 2 == 0
            and leaf.is_floating_point())


def quantize_params(params: dict) -> dict:
    """A new tree with eligible projections replaced by (packed, scale)
    pairs; other leaves are shared, not copied."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = quantize_params(leaf)
        elif _eligible(name, leaf):
            if leaf.ndim == 2:
                qw = quantize_w4(leaf)
                out[name + "__qp"], out[name + "__qs"] = qw.packed, qw.scale
                continue
            n_layers, k, n = leaf.shape
            packed = torch.empty((n_layers, k, n // 2), dtype=torch.uint8,
                                 device=leaf.device)
            scale = torch.empty((n_layers, -(-k // GROUP), n),
                                dtype=torch.float32, device=leaf.device)
            for i in range(n_layers):
                qw = quantize_w4(leaf[i])
                packed[i], scale[i] = qw.packed, qw.scale
            out[name + "__qp"], out[name + "__qs"] = packed, scale
        else:
            out[name] = leaf
    return out


def quantized_bytes(params: dict) -> tuple[int, int]:
    """(dense bytes, quantized bytes) of the eligible projections: 2 bytes
    an element in bf16 against a nibble an element and an f32 scale a
    128-element group."""
    dense = quant = 0
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            d, q = quantized_bytes(leaf)
            dense, quant = dense + d, quant + q
        elif _eligible(name, leaf):
            n = leaf.numel()
            dense += n * 2
            quant += n // 2 + (n // GROUP) * 4
    return dense, quant
