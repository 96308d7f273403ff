"""SwiftKV attention — the paper's core algorithm (Eqs. 5-8), batched.

Port of ``repro.core.swiftkv``. The reference writes single-head forms and
adds the batch and head axes with ``vmap``; here the axes are written out.
Decode shapes follow the reference kernel: queries grouped as
``q: [B, Hkv, G, D]`` (the ``G = Hq / Hkv`` query heads of a KV head share
its cache read) against caches in their native ``[B, S, Hkv, D]`` layout.

The running triple ``(mu, Z, Y)`` is an associative, commutative monoid
under :func:`state_merge`; :func:`state_update_block` folds one KV block and
:func:`state_finalize` applies the one deferred division.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Large-negative stand-in for -inf: exp(NEG_INF - x) underflows to 0 for any
# finite x, while NEG_INF - NEG_INF == 0 stays NaN-free (unlike -inf).
NEG_INF = -1e30


class SwiftKVState(NamedTuple):
    """``mu``: running max score, ``z``: running normalizer, ``y``: running
    unnormalized output. Leading dims are free."""

    mu: torch.Tensor  # [...]
    z: torch.Tensor   # [...]
    y: torch.Tensor   # [..., D]


def state_init(head_dim: int, batch_shape=(), *,
               device: torch.device | str = "cpu") -> SwiftKVState:
    f32 = torch.float32
    return SwiftKVState(
        mu=torch.full(tuple(batch_shape), NEG_INF, dtype=f32, device=device),
        z=torch.zeros(tuple(batch_shape), dtype=f32, device=device),
        y=torch.zeros((*batch_shape, head_dim), dtype=f32, device=device),
    )


def state_update_block(state: SwiftKVState, s_blk: torch.Tensor,
                       v_blk: torch.Tensor,
                       valid_blk: torch.Tensor) -> SwiftKVState:
    """Consume one KV block. ``s_blk: [..., Bk]`` pre-scaled scores,
    ``v_blk: [..., Bk, D]`` (broadcast against the leading dims of
    ``s_blk``), ``valid_blk: [..., Bk]`` float mask."""
    mu, z, y = state
    s_eff = torch.where(valid_blk > 0, s_blk, NEG_INF)
    mu_new = torch.maximum(mu, s_eff.amax(dim=-1))
    alpha = torch.exp(mu - mu_new)                           # rescale old state
    p = torch.exp(s_eff - mu_new[..., None]) * valid_blk     # [..., Bk] in [0, 1]
    z_new = alpha * z + p.sum(dim=-1)
    y_new = alpha[..., None] * y + (p.unsqueeze(-2) @ v_blk).squeeze(-2)
    return SwiftKVState(mu=mu_new, z=z_new, y=y_new)


def state_merge(a: SwiftKVState, b: SwiftKVState) -> SwiftKVState:
    """Associative, commutative combine of two partial states (the property
    that lets the single pass split across KV shards)."""
    mu = torch.maximum(a.mu, b.mu)
    ea = torch.exp(a.mu - mu)
    eb = torch.exp(b.mu - mu)
    return SwiftKVState(mu=mu, z=ea * a.z + eb * b.z,
                        y=ea[..., None] * a.y + eb[..., None] * b.y)


def state_finalize(state: SwiftKVState) -> torch.Tensor:
    """Eq. 8: the one deferred division. Fully masked states return 0."""
    z = state.z[..., None]
    return torch.where(z > 0, state.y / torch.where(z > 0, z, 1.0), 0.0)


def _valid_positions(t: torch.Tensor, lengths: torch.Tensor,
                     window: int | None) -> torch.Tensor:
    """[B, T] bool: cache position ``t`` attends for a row of ``lengths``."""
    valid = t[None, :] < lengths[:, None]
    if window is not None:
        valid &= t[None, :] >= lengths[:, None] - window
    return valid


def dequantize_cache(blk: torch.Tensor, sc: torch.Tensor | None) -> torch.Tensor:
    """``blk [B, T, Hkv, D]`` -> f32, times the ``[B, Hkv, T]`` scales of an
    int8 cache (position-last planes) where given."""
    blk = blk.float()
    if sc is not None:
        blk = blk * sc.float().transpose(1, 2)[..., None]
    return blk


def swiftkv_decode_blockwise(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             lengths: torch.Tensor | None = None,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None, *,
                             block_size: int = 512,
                             window: int | None = None,
                             scale: float | None = None) -> torch.Tensor:
    """Blockwise single-pass SwiftKV decode. q: [B, Hkv, G, D]; k, v:
    [B, S, Hkv, D]; lengths: [B] valid prefixes (default: S); k_scale /
    v_scale: optional [B, Hkv, S] dequant scales of an int8 cache.
    Returns [B, Hkv, G, D] in q.dtype.

    ``window``: only positions ``>= length - window`` attend. The loop runs
    ``cdiv(max(lengths), block_size)`` blocks — blocks past every row's
    prefix are exact no-ops, so they are skipped (one host read of
    ``lengths``). The ring form waits for the ring slice (ROADMAP §1)."""
    b, hkv, g, d = q.shape
    s_cache = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    if lengths is None:
        lengths = torch.full((b,), s_cache, dtype=torch.int32, device=q.device)
    lengths = lengths.to(torch.int64)
    n_live = min(-(-s_cache // block_size),
                 -(-int(lengths.max()) // block_size))
    qf = q.float()
    state = state_init(d, (b, hkv, g), device=q.device)
    for i in range(n_live):
        sl = slice(i * block_size, min((i + 1) * block_size, s_cache))
        k_blk = dequantize_cache(k[:, sl], None if k_scale is None else k_scale[..., sl])
        v_blk = dequantize_cache(v[:, sl], None if v_scale is None else v_scale[..., sl])
        t = torch.arange(sl.start, sl.stop, device=q.device)
        valid = _valid_positions(t, lengths, window).float()[:, None, None, :]
        s_blk = torch.einsum("bhgd,bshd->bhgs", qf, k_blk) * scale
        state = state_update_block(state, s_blk,
                                   v_blk.permute(0, 2, 1, 3)[:, :, None],
                                   valid)
    return state_finalize(state).to(q.dtype)


def softmax_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                lengths: torch.Tensor | None = None, *,
                                window: int | None = None,
                                scale: float | None = None) -> torch.Tensor:
    """Naive two-pass softmax attention (Eq. 4) — the correctness oracle.
    Materializes the full score matrix (exactly what SwiftKV avoids).
    q: [B, Hkv, G, D]; k, v: [B, S, Hkv, D] (any float dtype); lengths:
    [B]. Returns [B, Hkv, G, D] in q.dtype; a row with no valid position
    returns 0."""
    b, hkv, g, d = q.shape
    s_cache = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    if lengths is None:
        lengths = torch.full((b,), s_cache, dtype=torch.int32, device=q.device)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    valid = _valid_positions(torch.arange(s_cache, device=q.device),
                             lengths.to(torch.int64), window)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)
