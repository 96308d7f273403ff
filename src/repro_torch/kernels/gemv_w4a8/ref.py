"""Plain PyTorch version of the W4A8 kernel (dense unpack + exact integer
group sums)."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QuantizedLinear, w4a8_matmul_ref


def gemv_w4a8_ref(x: torch.Tensor, packed: torch.Tensor,
                  w_scale: torch.Tensor) -> torch.Tensor:
    """Same contract as ``ops.gemv_w4a8`` (float in / float32 out)."""
    return w4a8_matmul_ref(x, QuantizedLinear(packed=packed, scale=w_scale,
                                              bias=None))
