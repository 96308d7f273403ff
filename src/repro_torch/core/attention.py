"""Batched multi-head attention built on the SwiftKV primitives. Port of
``repro.core.attention`` (the self-attention entry points).

  * ``decode_attention``  — one new token against a KV cache (the paper's
    target workload). GQA-aware; dispatches between the blockwise form,
    the dense oracle and the hand-written CUDA kernel.
  * ``prefill_attention`` — multi-token attention as a single-pass
    blockwise scan over KV blocks with the same ``(mu, Z, Y)`` recurrence.

Layouts: activations ``[B, S, H, D]``; KV caches ``[B, S, Hkv, D]``.
The ring and pooled (cross-attention) entry points wait for their slices
(ROADMAP §1).
"""
from __future__ import annotations

import torch

from . import swiftkv
from .swiftkv import NEG_INF, SwiftKVState, state_finalize, state_init


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     impl: str = "blockwise", window: int | None = None,
                     ring: bool = False, block_size: int = 512,
                     scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, Hq, D]; k_cache/v_cache: [B, S, Hkv, D]; lengths: [B] int32.
    Returns [B, Hq, D]. Hq must be a multiple of Hkv (GQA groups).

    ``impl``: ``kernel`` (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors), ``blockwise`` (single-pass torch loop) or
    ``naive`` (dense two-pass oracle). ``k_scale`` / ``v_scale``: optional
    [B, Hkv, S] dequant scales of an int8 cache."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_attention: Hq={hq} not a multiple of Hkv={hkv}")
    if ring:
        raise NotImplementedError(
            "decode_attention: ring caches wait for the ring slice "
            "(ROADMAP §1 item 7)")
    if impl == "kernel":
        from repro_torch.kernels.swiftkv_decode import ops as kops
        return kops.swiftkv_decode(q, k_cache, v_cache, lengths, window=window,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale)
    qg = q.reshape(b, hkv, hq // hkv, d)
    if impl == "blockwise":
        out = swiftkv.swiftkv_decode_blockwise(
            qg, k_cache, v_cache, lengths, k_scale, v_scale,
            block_size=block_size, window=window, scale=scale)
    elif impl == "naive":
        if k_scale is not None:
            # dense oracle: dequantize the whole cache up front
            k_cache = swiftkv.dequantize_cache(k_cache, k_scale)
            v_cache = swiftkv.dequantize_cache(v_cache, v_scale)
        out = swiftkv.softmax_attention_reference(
            qg, k_cache, v_cache, lengths, window=window, scale=scale)
    else:
        raise NotImplementedError(
            f"decode_attention: impl={impl!r} is not ported "
            "(kernel | blockwise | naive); see ROADMAP §1")
    return out.reshape(b, hq, d)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      kv_lengths: torch.Tensor | None = None,
                      q_offset: torch.Tensor | None = None,
                      kv_block: int = 512,
                      scale: float | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D].

    Single pass over KV blocks with the SwiftKV ``(mu, Z, Y)`` state per
    query row (no Sq x Skv score matrix beyond one block). GQA KV heads are
    repeated to the query-head count, as in the reference.

    ``kv_lengths``: [B] valid KV prefix. ``q_offset``: [B] absolute position
    of q row 0 (0 for prefill)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = (1.0 / (d ** 0.5)) if scale is None else scale
    if kv_lengths is None:
        kv_lengths = torch.full((b,), skv, dtype=torch.int64, device=dev)
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int64, device=dev)

    qf = q.transpose(1, 2).float() * scale                  # [B, Hq, Sq, D]
    kh = k.transpose(1, 2)                                  # [B, Hkv, Skv, D]
    vh = v.transpose(1, 2)
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    pos_q = q_offset.to(torch.int64)[:, None] + torch.arange(sq, device=dev)[None]

    state: SwiftKVState = state_init(d, (b, hq, sq), device=dev)
    for start in range(0, skv, kv_block):
        stop = min(start + kv_block, skv)
        k_blk = kh[:, :, start:stop].float()
        v_blk = vh[:, :, start:stop].float()
        pos_k = torch.arange(start, stop, device=dev)      # [Bk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk)      # [B, H, Sq, Bk]
        valid = (pos_k[None, None, :] < kv_lengths.to(torch.int64)[:, None, None]
                 ).expand(b, sq, stop - start)
        if causal:
            valid = valid & (pos_k[None, None, :] <= pos_q[:, :, None])
        if window is not None:
            valid = valid & (pos_k[None, None, :] > pos_q[:, :, None] - window)
        valid = valid[:, None]                               # [B, 1, Sq, Bk]
        s = torch.where(valid, s, NEG_INF)
        mu, z, y = state
        mu_new = torch.maximum(mu, s.amax(dim=-1))
        alpha = torch.exp(mu - mu_new)
        p = torch.exp(s - mu_new[..., None]) * valid
        state = SwiftKVState(mu=mu_new, z=alpha * z + p.sum(dim=-1),
                             y=alpha[..., None] * y + p @ v_blk)
    out = state_finalize(state).to(q.dtype)                  # [B, Hq, Sq, D]
    return out.transpose(1, 2)
