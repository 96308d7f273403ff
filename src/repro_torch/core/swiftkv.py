"""SwiftKV attention — the paper's core algorithm (Eqs. 5-8), batched.

Port of ``repro.core.swiftkv``. The reference writes single-head forms and
adds the batch and head axes with ``vmap``; here the axes are written out.
Decode shapes follow the reference kernel: queries grouped as
``q: [B, Hkv, G, D]`` (the ``G = Hq / Hkv`` query heads of a KV head share
its cache read) against caches in their native ``[B, S, Hkv, D]`` layout.

Two decode realizations, both exact: :func:`swiftkv_decode_tokenwise`,
the paper-faithful per-token recurrence with the literal two-branch update
of Eqs. (6)/(7), and :func:`swiftkv_decode_blockwise`, the same recurrence
at KV-block granularity (:func:`swiftkv_decode_pooled`: its form over a
shared source-KV pool, one entry per row). The running triple
``(mu, Z, Y)`` is an associative, commutative monoid under
:func:`state_merge`;
:func:`state_update_block` folds one KV block and :func:`state_finalize`
applies the one deferred division.
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
                       v_blk: torch.Tensor, valid_blk: torch.Tensor, *,
                       exp=torch.exp) -> SwiftKVState:
    """Consume one KV block. ``s_blk: [..., Bk]`` pre-scaled scores,
    ``v_blk: [..., Bk, D]`` (broadcast against the leading dims of
    ``s_blk``), ``valid_blk: [..., Bk]`` float mask. ``exp``: the
    exponential (the kernel's LUT form passes its own)."""
    mu, z, y = state
    s_eff = torch.where(valid_blk > 0, s_blk, NEG_INF)
    mu_new = torch.maximum(mu, s_eff.amax(dim=-1))
    alpha = exp(mu - mu_new)                                 # rescale old state
    p = exp(s_eff - mu_new[..., None]) * valid_blk           # [..., Bk] in [0, 1]
    z_new = alpha * z + p.sum(dim=-1)
    y_new = alpha[..., None] * y + (p.unsqueeze(-2) @ v_blk).squeeze(-2)
    return SwiftKVState(mu=mu_new, z=z_new, y=y_new)


def state_merge(a: SwiftKVState, b: SwiftKVState, *,
                exp=torch.exp) -> SwiftKVState:
    """Associative, commutative combine of two partial states (the property
    that lets the single pass split across KV shards)."""
    mu = torch.maximum(a.mu, b.mu)
    ea = exp(a.mu - mu)
    eb = exp(b.mu - mu)
    return SwiftKVState(mu=mu, z=ea * a.z + eb * b.z,
                        y=ea[..., None] * a.y + eb[..., None] * b.y)


def state_finalize(state: SwiftKVState) -> torch.Tensor:
    """Eq. 8: the one deferred division. Fully masked states return 0."""
    z = state.z[..., None]
    return torch.where(z > 0, state.y / torch.where(z > 0, z, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Paper-faithful per-token recurrence (Eqs. 5-8)
# ---------------------------------------------------------------------------

def _token_update_branchy(state: SwiftKVState, s_t: torch.Tensor, v_t: torch.Tensor,
                          valid: torch.Tensor) -> SwiftKVState:
    """Literal Eqs. (6)/(7): two branches selected by ``s_t <= mu``.
    ``s_t``, ``valid`` (bool): [...]; ``v_t``: [..., D] (broadcast).
    ``valid`` masks padded cache slots: a masked token passes the state
    through."""
    mu, z, y = state
    le = s_t <= mu
    # branch (6): s_t <= mu            # branch (7): s_t > mu
    beta = torch.exp(s_t - mu)         # alpha = exp(mu - s_t)
    alpha = torch.exp(mu - s_t)
    z_le = z + beta
    y_le = y + beta[..., None] * v_t
    z_gt = alpha * z + 1.0
    y_gt = alpha[..., None] * y + v_t
    mu_new = torch.where(le, mu, s_t)
    z_new = torch.where(le, z_le, z_gt)
    y_new = torch.where(le[..., None], y_le, y_gt)
    return SwiftKVState(mu=torch.where(valid, mu_new, mu),
                        z=torch.where(valid, z_new, z),
                        y=torch.where(valid[..., None], y_new, y))


def _token_update_fused(state: SwiftKVState, s_t: torch.Tensor, v_t: torch.Tensor,
                        valid: torch.Tensor) -> SwiftKVState:
    """Branch-free rewrite of Eqs. (6)/(7): with ``mu' = max(mu, s_t)`` both
    branches become ``z' = e^{mu-mu'} z + e^{s_t-mu'}``; exponent arguments
    stay in (-inf, 0] as the paper's hardware exp requires. Shapes as
    :func:`_token_update_branchy` (``valid`` bool)."""
    mu, z, y = state
    s_eff = torch.where(valid, s_t, NEG_INF)
    mu_new = torch.maximum(mu, s_eff)
    alpha = torch.exp(mu - mu_new)                     # in (0, 1]
    beta = torch.exp(s_eff - mu_new) * valid.float()   # in (0, 1]; 0 when masked
    return SwiftKVState(mu=mu_new, z=alpha * z + beta,
                        y=alpha[..., None] * y + beta[..., None] * v_t)


def swiftkv_decode_tokenwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor | None = None, *,
                             branchy: bool = True,
                             scale: float | None = None) -> torch.Tensor:
    """Paper-faithful SwiftKV decode attention: every cache slot read once,
    one ``(k_t, v_t)`` per step, then one deferred normalization (Eq. 8).
    q: [B, Hkv, G, D]; k, v: [B, S, Hkv, D]; lengths: [B] valid prefixes
    (default: S). Returns [B, Hkv, G, D] in q.dtype.

    The reference scans the S slots with ``lax.scan`` per (row, head) under
    ``vmap``; here one Python step per slot updates every (row, head,
    query) at once, masked by ``t < lengths`` on the device (``lengths``
    is never read on the host)."""
    b, hkv, g, d = q.shape
    s_cache = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    if lengths is None:
        lengths = torch.full((b,), s_cache, dtype=torch.int32, device=q.device)
    update = _token_update_branchy if branchy else _token_update_fused
    qf = q.float()
    live = lengths.to(torch.int64)[:, None, None]                   # [B, 1, 1]
    state = state_init(d, (b, hkv, g), device=q.device)
    for t in range(s_cache):
        s_t = torch.einsum("bhgd,bhd->bhg", qf, k[:, t].float()) * scale   # Eq. 5
        valid = (t < live).expand(b, hkv, g)
        state = update(state, s_t, v[:, t].float()[:, :, None], valid)
    return state_finalize(state).to(q.dtype)


def _valid_positions(t: torch.Tensor, lengths: torch.Tensor,
                     window: int | None, ring_len: int | None = None) -> torch.Tensor:
    """[B, T] bool: cache slot ``t`` attends for a row of ``lengths``.

    ``ring_len``: the cache is a ring of R slots where slot ``t`` holds
    absolute position ``p - ((p - t) mod R)`` for ``p = lengths - 1``; the
    slot attends iff that position is ``>= 0`` and ``> p - window``
    (``lengths`` counts the tokens seen and may exceed R)."""
    if ring_len is not None:
        p = lengths[:, None] - 1
        pos = p - torch.remainder(p - t[None, :], ring_len)
        return (t[None, :] < ring_len) & (pos >= 0) & (pos > p - window)
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
                             ring: bool = False,
                             scale: float | None = None) -> torch.Tensor:
    """Blockwise single-pass SwiftKV decode. q: [B, Hkv, G, D]; k, v:
    [B, S, Hkv, D]; lengths: [B] valid prefixes (default: S); k_scale /
    v_scale: optional [B, Hkv, S] dequant scales of an int8 cache.
    Returns [B, Hkv, G, D] in q.dtype.

    ``window``: only positions ``>= length - window`` attend. ``ring``: the
    cache is a ring of R = S slots (slot ``s`` holds position ``p - ((p -
    s) mod R)``, ``p = length - 1``; needs ``window``), consumed in place:
    validity comes from each slot's position, and the (mu, Z, Y) fold is
    order-independent, so ring order folds to the temporal result. The
    loop runs ``cdiv(max(lengths), block_size)`` blocks (all of a wrapped
    ring) — blocks past every row's prefix are exact no-ops, so they are
    skipped (one host read of ``lengths``)."""
    if ring and window is None:
        raise ValueError("ring caches are windowed: pass window with ring=True")
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
        valid = _valid_positions(t, lengths, window,
                                 s_cache if ring else None).float()[:, None, None, :]
        s_blk = torch.einsum("bhgd,bshd->bhgs", qf, k_blk) * scale
        state = state_update_block(state, s_blk,
                                   v_blk.permute(0, 2, 1, 3)[:, :, None],
                                   valid)
    return state_finalize(state).to(q.dtype)


def swiftkv_decode_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, entries: torch.Tensor,
                          lengths: torch.Tensor,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None, *,
                          block_size: int = 512,
                          scale: float | None = None) -> torch.Tensor:
    """Blockwise single-pass decode reading one entry of a shared
    source-KV pool per row: the ragged cross-attention read. q: [B, Hkv,
    G, D]; k_pool, v_pool: [E, S, Hkv, D] (E entries, not batched by row);
    entries: [B] the entry row ``b`` reads; lengths: [B] that entry's valid
    prefix; k_scale / v_scale: optional [E, Hkv, S] scales of an int8 pool.
    Returns [B, Hkv, G, D] in q.dtype.

    The entry index goes into each block's read (``k_pool[entries, block]``),
    so no per-row copy of the whole pool is made. Cross attention is
    non-causal and unwindowed: a position attends iff ``t < length``, and
    a ``length == 0`` row folds nothing and finalizes to an exact 0. The
    loop runs ``cdiv(max(lengths), block_size)`` blocks (one host read of
    ``lengths``), as :func:`swiftkv_decode_blockwise` does."""
    b, hkv, g, d = q.shape
    s_pool = k_pool.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    entries = entries.to(torch.int64)
    lengths = lengths.to(torch.int64)
    n_live = min(-(-s_pool // block_size), -(-int(lengths.max()) // block_size))
    qf = q.float()
    state = state_init(d, (b, hkv, g), device=q.device)
    for i in range(n_live):
        sl = slice(i * block_size, min((i + 1) * block_size, s_pool))
        k_blk = dequantize_cache(k_pool[entries, sl],
                                 None if k_scale is None else k_scale[entries, :, sl])
        v_blk = dequantize_cache(v_pool[entries, sl],
                                 None if v_scale is None else v_scale[entries, :, sl])
        t = torch.arange(sl.start, sl.stop, device=q.device)
        valid = _valid_positions(t, lengths, None).float()[:, None, None, :]
        s_blk = torch.einsum("bhgd,bshd->bhgs", qf, k_blk) * scale
        state = state_update_block(state, s_blk, v_blk.permute(0, 2, 1, 3)[:, :, None],
                                   valid)
    return state_finalize(state).to(q.dtype)


def swiftkv_decode_sharded_reference(q: torch.Tensor, k_shards, v_shards,
                                     lengths) -> torch.Tensor:
    """The one-process model of sequence-parallel decode: fold each KV shard
    on its own, then merge the partial states in shard order. q: [..., D];
    each shard k, v: [S_i, D] (or [..., S_i, D]); ``lengths``: each
    shard's valid prefix. A shard with no valid position folds to Z = 0 and
    adds nothing to the merge. Returns [..., D] in q.dtype."""
    states = []
    for k, v, ln in zip(k_shards, v_shards, lengths):
        d = q.shape[-1]
        t = torch.arange(k.shape[-2], device=q.device)
        s = (k.float() @ q.float()[..., None])[..., 0] * (1.0 / d ** 0.5)
        states.append(state_update_block(state_init(v.shape[-1], s.shape[:-1], device=q.device),
                                         s, v.float(), (t < ln).float()))
    acc = states[0]
    for st in states[1:]:
        acc = state_merge(acc, st)
    return state_finalize(acc).to(q.dtype)


def softmax_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                lengths: torch.Tensor | None = None, *,
                                window: int | None = None,
                                ring: bool = False,
                                scale: float | None = None) -> torch.Tensor:
    """Naive two-pass softmax attention (Eq. 4) — the correctness oracle.
    Materializes the full score matrix (exactly what SwiftKV avoids).
    q: [B, Hkv, G, D]; k, v: [B, S, Hkv, D] (any float dtype); lengths:
    [B]. Returns [B, Hkv, G, D] in q.dtype; a row with no valid position
    returns 0. ``ring``: k, v are rings of S slots, masked by position as
    in :func:`swiftkv_decode_blockwise`."""
    b, hkv, g, d = q.shape
    s_cache = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    if lengths is None:
        lengths = torch.full((b,), s_cache, dtype=torch.int32, device=q.device)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    valid = _valid_positions(torch.arange(s_cache, device=q.device),
                             lengths.to(torch.int64), window,
                             s_cache if ring else None)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)
