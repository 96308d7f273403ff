"""Plain PyTorch versions of the W4A8 kernels (dense unpack + exact integer
group sums), and a plain model of the decode form's split of K."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import (GROUP, QuantizedLinear, quantize_a8, unpack_w4,
                                           w4a8_matmul_ref)


def gemv_w4a8_ref(x: torch.Tensor, packed: torch.Tensor,
                  w_scale: torch.Tensor) -> torch.Tensor:
    """Same contract as ``ops.gemv_w4a8`` (float in / float32 out)."""
    return w4a8_matmul_ref(x, QuantizedLinear(packed=packed, scale=w_scale,
                                              bias=None))


def rank_groups(n_groups: int, ks: int) -> list[tuple[int, int]]:
    """The decode form's K split: rank r of ``ks`` takes the 128-row groups
    [r G / ks, (r + 1) G / ks), in order, as the kernel computes them."""
    return [(r * n_groups // ks, (r + 1) * n_groups // ks) for r in range(ks)]


def gemv_w4a8_split_ref(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor, *,
                        ks: int) -> torch.Tensor:
    """The decode form's split in plain PyTorch: the rows quantized as
    ``quantize_a8`` does, each rank's groups summed (exact integer group
    sums times the group scales), the ranks' partials added in rank order,
    then scaled by the row scales. x: [M, K] float -> [M, N] f32."""
    xq, xs = quantize_a8(x)
    k = xq.shape[-1]
    n = packed.shape[1] * 2
    w = unpack_w4(packed)                                        # [K, N] int8
    pad_k = (-k) % GROUP
    if pad_k:
        xq = F.pad(xq, (0, pad_k))
        w = F.pad(w, (0, 0, 0, pad_k))
    g = w.shape[0] // GROUP
    xg = xq.reshape(-1, g, GROUP).transpose(0, 1).float()        # [G, M, 128]
    wg = w.reshape(g, GROUP, n).float()                          # [G, 128, N]
    acc = torch.bmm(xg, wg) * w_scale[:g, None, :]               # [G, M, N], exact sums
    total = None
    for g0, g1 in rank_groups(g, ks):
        part = acc[g0:g1].sum(dim=0)
        total = part if total is None else total + part
    return total * xs
