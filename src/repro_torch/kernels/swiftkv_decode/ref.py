"""Plain PyTorch versions of the SwiftKV decode kernel.

``swiftkv_decode_ref`` is the dense two-pass softmax oracle (materializes
scores — exactly what the kernel avoids), extended to int8 caches with
per-position scales and to ring caches (masked by each slot's position).
``swiftkv_decode_split_ref`` models the kernel's split of the positions
over CTAs (same chunks, partial states merged in the same order; a ring's
chunks are cut in position space and read at ``t mod S``, as the kernel
reads them); only tests and the chip smoke test use it.
"""
from __future__ import annotations

import torch

from repro_torch.core.swiftkv import (dequantize_cache,
                                      softmax_attention_reference, state_finalize,
                                      state_init, state_merge, state_update_block)

TILE = 32   # positions per CTA step of the kernel (kTile)


def swiftkv_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor, *,
                       window: int | None = None, scale: float | None = None,
                       ring: bool = False,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B]; k_scale /
    v_scale: optional [B, Hkv, S] scales of an int8 cache -> [B, Hq, D].
    ``ring``: the caches are rings of S slots (``lengths`` counts the
    tokens seen; slot s holds position ``p - ((p - s) mod S)``, p =
    lengths - 1, and attends iff that position is >= 0 and > p - window)."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale)
        v_cache = dequantize_cache(v_cache, v_scale)
    out = softmax_attention_reference(q.reshape(b, hkv, hq // hkv, d),
                                      k_cache, v_cache, lengths,
                                      window=window, ring=ring, scale=scale)
    return out.reshape(b, hq, d)


def chunk_bounds(lengths: torch.Tensor, s_len: int, *, n_split: int,
                 tile: int = TILE, window: int | None = None,
                 ring: bool = False) -> list:
    """The kernel's chunks: ``[(start, end)] * n_split``, each a [B] tensor.
    Positions [lo, len) (len = min(lengths, S), lo = max(0, len - window))
    are cut into tiles aligned to absolute position 0; split i takes the
    i-th run of ``cdiv(n_tiles, n_split)`` tiles, clipped to [lo, len).
    A split with ``end <= start`` is empty. ``ring``: positions, not slots
    — len = lengths unclamped and lo = max(0, len - min(window, S)), the
    window's positions, each at slot ``t mod S``."""
    length = lengths.to(torch.int64).clamp(min=0)
    if ring:
        window = min(window, s_len)
    else:
        length = length.clamp(max=s_len)
    lo = (length - window).clamp(min=0) if window else torch.zeros_like(length)
    first = lo // tile
    n_tiles = torch.where(length > lo, -(-length // tile) - first, 0)
    per = -(-n_tiles // n_split)
    bounds = []
    for i in range(n_split):
        t0 = (first + torch.minimum(n_tiles, i * per)) * tile
        t1 = (first + torch.minimum(n_tiles, (i + 1) * per)) * tile
        bounds.append((torch.maximum(lo, t0), torch.minimum(length, t1)))
    return bounds


def swiftkv_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor, *, n_split: int,
                             tile: int = TILE, window: int | None = None,
                             scale: float | None = None, ring: bool = False,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's split decode in plain PyTorch: each chunk of
    :func:`chunk_bounds` folded by ``state_update_block`` into a partial
    (mu, Z, Y), the partials merged by ``state_merge`` left to right (split
    order, as the kernel merges them), then the one deferred division.
    Shapes as :func:`swiftkv_decode_ref`. ``ring``: the ring is read at
    ``t mod S`` for positions ``t`` (:func:`unroll_ring`) and split as the
    linear cache holding those positions, with window ``min(window, S)``:
    the kernel's ring and linear forms fold the same chunks in the same
    order."""
    if ring:
        s_len = k.shape[1]
        k, v = unroll_ring(k, lengths, 1), unroll_ring(v, lengths, 1)
        if k_scale is not None:
            k_scale = unroll_ring(k_scale, lengths, 2)
            v_scale = unroll_ring(v_scale, lengths, 2)
        return swiftkv_decode_split_ref(q, k, v, lengths, n_split=n_split, tile=tile,
                                        window=min(window, s_len), scale=scale,
                                        k_scale=k_scale, v_scale=v_scale)
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    kf = dequantize_cache(k, k_scale)
    vf = dequantize_cache(v, v_scale).permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, D]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(b, hkv, hq // hkv, d).float(), kf) * scale
    t = torch.arange(s_len, device=q.device)
    acc = None
    for start, end in chunk_bounds(lengths, s_len, n_split=n_split, tile=tile,
                                   window=window):
        valid = ((t >= start[:, None]) & (t < end[:, None])).float()[:, None, None, :]
        part = state_update_block(state_init(d, s.shape[:3], device=q.device), s, vf, valid)
        acc = part if acc is None else state_merge(acc, part)
    return state_finalize(acc).reshape(b, hq, d).to(q.dtype)


def unroll_ring(x: torch.Tensor, lengths: torch.Tensor, axis: int) -> torch.Tensor:
    """A ring's slots in position order: ``x`` with its slot axis ``axis``
    (of S slots) replaced by positions ``t`` in [0, max(lengths)), each
    read at slot ``t mod S``: the linear cache that holds the ring's window
    at the same positions (earlier positions hold whatever their slot holds
    now, and lie outside every window)."""
    s_len = x.shape[axis]
    n_pos = max(1, int(lengths.max()))
    idx = torch.arange(n_pos, device=x.device) % s_len
    return x.index_select(axis, idx)
