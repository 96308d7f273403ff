"""W4A8 quantization (paper §IV-B): INT4 weights x INT8 activations -> INT32
partial sums, rescaled to higher precision between ops. Port of
``repro.core.quantization``.

Weights: symmetric group-wise int4 in [-8, 7] — one f32 scale per
(128-input-channel group, output channel) — packed two nibbles per uint8
along the output axis (low nibble = even channel). Activations: symmetric
per-token dynamic int8. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the integer codes agree with the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

GROUP = 128  # input channels per quantization group


class QuantizedLinear(NamedTuple):
    """Packed W4 weight for a [K, N] linear layer."""
    packed: torch.Tensor   # [K, N//2] uint8 — two int4 output channels per byte
    scale: torch.Tensor    # [ceil(K/GROUP), N] f32 per-(group, out-channel) scale
    bias: torch.Tensor | None


_CLIP_CANDIDATES = (0.7, 0.8, 0.85, 0.9, 1.0)


def quantize_w4(w: torch.Tensor, group: int = GROUP) -> QuantizedLinear:
    """w: [K, N] float -> group-wise symmetric int4, packed along N.

    Per-group MSE search over clip factors; a candidate replaces the best so
    far only on a strictly smaller error, as in the reference."""
    k, n = w.shape
    if n % 2:
        raise ValueError("quantize_w4: output dim must be even to pack nibbles")
    w = w.float()
    pad_k = (-k) % group
    if pad_k:
        w = F.pad(w, (0, 0, 0, pad_k))
    kp = w.shape[0]
    wg = w.reshape(kp // group, group, n)
    amax = wg.abs().amax(dim=1)                                  # [K/G, N]

    best_scale = best_err = None
    for c in _CLIP_CANDIDATES:
        s = torch.where(amax > 0, c * amax / 7.0, 1.0).float()
        qc = torch.clamp(torch.round(wg / s[:, None, :]), -8, 7)
        err = ((qc * s[:, None, :] - wg) ** 2).sum(dim=1)        # [K/G, N]
        if best_err is None:
            best_scale, best_err = s, err
        else:
            pick = err < best_err
            best_scale = torch.where(pick, s, best_scale)
            best_err = torch.minimum(err, best_err)

    q = torch.clamp(torch.round(wg / best_scale[:, None, :]), -8, 7)
    q = q.reshape(kp, n)[:k].to(torch.int8)
    lo = q[:, 0::2].to(torch.uint8) & 0xF
    hi = (q[:, 1::2].to(torch.uint8) & 0xF) << 4
    return QuantizedLinear(packed=lo | hi, scale=best_scale, bias=None)


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """[K, N//2] uint8 -> [K, N] int8 in [-8, 7] (sign-extended nibbles)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def quantize_a8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) symmetric int8. x: [..., K] -> (q, scale[..., 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def w4a8_matmul_ref(x: torch.Tensor, qw: QuantizedLinear,
                    group: int = GROUP) -> torch.Tensor:
    """Reference W4A8 linear: quantize activations, integer-accumulate per
    group, group-rescale, sum. x: [..., K] float -> [..., N] float32.

    The per-group integer sums are taken in float32, which is exact here:
    every product is at most 127 * 8 and a group sums 128 of them, so each
    partial sum stays below 2**24. That keeps one code path on the CPU and
    on the GPU (which has no int32 matmul)."""
    xq, xs = quantize_a8(x)
    k = xq.shape[-1]
    n = qw.packed.shape[1] * 2
    pad_k = (-k) % group
    w = unpack_w4(qw.packed)                                     # [K, N] int8
    if pad_k:
        xq = F.pad(xq, (0, pad_k))
        w = F.pad(w, (0, 0, 0, pad_k))
    g = w.shape[0] // group
    xg = xq.reshape(-1, g, group).transpose(0, 1).float()        # [G, M, 128]
    wg = w.reshape(g, group, n).float()                          # [G, 128, N]
    acc = torch.bmm(xg, wg)                                      # [G, M, N] exact
    out = (acc * qw.scale[:, None, :]).sum(dim=0)                # [M, N]
    out = out.reshape(*xq.shape[:-1], n) * xs
    if qw.bias is not None:
        out = out + qw.bias
    return out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dimension (last axis) — the serving KV
    cache's storage form. x: [..., Dh] float -> (q [..., Dh] int8,
    scale [...] f32), scale = amax / 127; an all-zero row stores scale 0."""
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 0.0).float()
    safe = torch.where(scale > 0, scale, 1.0)[..., None]
    q = torch.clamp(torch.round(x.float() / safe), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`. -> [..., Dh] f32."""
    return q.float() * scale[..., None]
