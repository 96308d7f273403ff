"""Batched multi-head attention built on the SwiftKV primitives. Port of
``repro.core.attention`` (the self-attention entry points).

  * ``decode_attention``  — one new token against a KV cache (the paper's
    target workload). GQA-aware; dispatches between the paper-faithful
    tokenwise recurrence, the blockwise form, the dense oracle and the
    hand-written CUDA kernel.
  * ``decode_cross_attention`` — the same read over a shared source-KV
    pool, each row reading its own entry (continuous cross-attention
    serving).
  * ``prefill_attention`` — multi-token attention as a single-pass
    blockwise scan over KV blocks with the same ``(mu, Z, Y)`` recurrence.
  * ``decode_attention_ring`` / ``prefill_attention_ring`` — the dense
    sliding-window forms over a RING KV cache of ~window slots (decode's
    oracle, and a prompt chunk's attention).

Layouts: activations ``[B, S, H, D]``; KV caches ``[B, S, Hkv, D]``;
source-KV pools ``[E, S_src, Hkv, D]``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (constrain_batch_model, is_dtensor, local_chunk,
                                              replicate_where, replicated_value, shard_range)

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
    version for CPU tensors), ``tokenwise`` (the per-token recurrence of
    Eqs. 5-8, one step per cache slot), ``blockwise`` (single-pass torch
    loop), ``naive`` (dense two-pass oracle; with ``ring``,
    :func:`decode_attention_ring`) or ``sp`` (sequence-parallel: under an
    active ``distributed.context`` with a model axis that divides S, each
    process folds its slice of the cache and the partial states merge over
    one all-gather, ``distributed/sp_attention.py``; otherwise
    ``blockwise``). ``k_scale`` / ``v_scale``: optional [B, Hkv, S]
    dequant scales of an int8 cache. ``ring``: the caches are rings of S
    slots and ``lengths`` counts the tokens seen; needs ``window``. As in
    the reference, ``tokenwise`` and ``sp`` have no int8 and no ring form
    and take ``blockwise`` for them, and ``tokenwise`` raises for a linear
    window."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_attention: Hq={hq} not a multiple of Hkv={hkv}")
    if ring and window is None:
        raise ValueError("ring caches are windowed: pass window")
    if impl in ("tokenwise", "sp") and (k_scale is not None or ring):
        impl = "blockwise"       # no per-token or sequence-parallel int8 or ring form
    if impl == "sp":
        from repro_torch.distributed.context import get_context
        ctx = get_context()
        s_len = k_cache.shape[1]
        if (ctx.active and ctx.model_axis is not None
                and s_len % ctx.axis_size(ctx.model_axis) == 0):
            from repro_torch.distributed.sp_attention import decode_attention_sp
            return decode_attention_sp(
                q, k_cache, v_cache, lengths, mesh=ctx.mesh, seq_axes=ctx.model_axis,
                window=window, scale=scale,
                block_size=min(block_size, s_len // ctx.axis_size(ctx.model_axis)))
        impl = "blockwise"
    if impl == "kernel":
        from repro_torch.kernels.swiftkv_decode import ops as kops
        return kops.swiftkv_decode(q, k_cache, v_cache, lengths, window=window,
                                   scale=scale, ring=ring, k_scale=k_scale,
                                   v_scale=v_scale)
    if impl == "blockwise" and is_dtensor(k_cache) and k_scale is None and not ring:
        return _decode_blockwise_local(q, k_cache, v_cache, lengths, window=window,
                                       block_size=block_size, scale=scale)
    qg = q.reshape(b, hkv, hq // hkv, d)
    if impl == "tokenwise":
        if window is not None:
            raise NotImplementedError("tokenwise path: use blockwise for SWA")
        out = swiftkv.swiftkv_decode_tokenwise(qg, k_cache, v_cache, lengths,
                                               scale=scale)
    elif impl == "blockwise":
        out = swiftkv.swiftkv_decode_blockwise(
            qg, k_cache, v_cache, lengths, k_scale, v_scale,
            block_size=block_size, window=window, ring=ring, scale=scale)
    elif impl == "naive":
        if k_scale is not None:
            # dense oracle: dequantize the whole cache up front
            k_cache = swiftkv.dequantize_cache(k_cache, k_scale)
            v_cache = swiftkv.dequantize_cache(v_cache, v_scale)
        if ring:
            return decode_attention_ring(q, k_cache, v_cache, lengths,
                                         window=window, scale=scale)
        out = swiftkv.softmax_attention_reference(
            qg, k_cache, v_cache, lengths, window=window, scale=scale)
    else:
        raise NotImplementedError(
            f"decode_attention: impl={impl!r} is not one of "
            "(kernel | tokenwise | blockwise | naive | sp)")
    return out.reshape(b, hq, d)


def _decode_blockwise_local(q, k_cache, v_cache, lengths, *, window: int | None,
                            block_size: int, scale: float | None):
    """The blockwise decode on a ``DTensor`` cache [B, S, Hkv, D], sharded
    over its batch and its sequence (``cache_specs``): each process folds
    its own rows and positions into a partial ``(mu, Z, Y)`` state, every
    block of its slice (no host read of ``lengths``), and the states merge
    over the mesh dims that shard the sequence as two all-reduces: the max
    of mu, then the sum of Z and Y rescaled to it (the monoid merge,
    associative, so exact up to float32 rounding). Slicing the cache into
    blocks as DTensor would instead gathers the whole cache. Returns [B,
    Hq, D], its rows placed as the cache's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.sp_attention import _local_partial_state
    mesh = k_cache.device_mesh
    keep = lambda i, pl: pl.is_shard() and pl.dim not in (0, 1)
    k_cache, v_cache = (replicate_where(t, keep) for t in (k_cache, v_cache))
    pls = list(k_cache.placements)
    rows = [Shard(0) if pl.is_shard(0) else Replicate() for pl in pls]
    local = lambda t: (t.redistribute(mesh, rows).to_local() if is_dtensor(t)
                       else local_chunk(t, rows, mesh))
    q_l, len_l = local(q), local(lengths)
    b, hq, d = q_l.shape
    hkv = k_cache.shape[2]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    lo, _ = shard_range(k_cache.shape[1], pls, mesh, 1)
    st = _local_partial_state(q_l.reshape(b, hkv, hq // hkv, d), k_cache.to_local(),
                              v_cache.to_local(), len_l, lo, window=window,
                              block_size=block_size, scale=scale)
    seq = [i for i, pl in enumerate(pls) if pl.is_shard(1)]
    if seq:
        def reduce(t, op):
            spec = [Partial(op) if i in seq else pl for i, pl in enumerate(rows)]
            return DTensor.from_local(t, mesh, spec, run_check=False).redistribute(
                mesh, rows).to_local()
        mu = reduce(st.mu, "max")
        alpha = torch.exp(st.mu - mu)
        st = SwiftKVState(mu=mu, z=reduce(alpha * st.z, "sum"),
                          y=reduce(alpha[..., None] * st.y, "sum"))
    out = state_finalize(st).to(q_l.dtype).reshape(b, hq, d)
    shape = (q.shape[0], hq, d)
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=torch.Size(shape),
                              stride=(hq * d, d, 1))


def decode_cross_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, entries: torch.Tensor,
                           lengths: torch.Tensor, *, impl: str = "blockwise",
                           block_size: int = 512, scale: float | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged cross-attention decode read over a shared source-KV pool.

    q: [B, Hq, D] (one decoder token per slot); k_pool / v_pool: [E, S_src,
    Hkv, D], E pooled entries, not batched by slot; entries: [B] each
    slot's entry (slots that share a source share an entry); lengths: [B]
    each slot's valid source prefix. A ``length == 0`` row reads an exact
    0. Non-causal, unwindowed and read-only. k_scale / v_scale: optional
    [E, Hkv, S_src] scales of an int8 pool.

    ``impl``: ``naive`` gathers each slot's entry and runs the dense
    oracle; ``blockwise`` (and ``tokenwise``, which has no pooled form, as
    in the reference) runs :func:`swiftkv.swiftkv_decode_pooled`;
    ``kernel`` calls the decode kernel's wrapper with ``entries=``, which
    reads each row's entry in place (on CPU tensors the wrapper runs the
    blockwise pooled loop, where the reference runs blockwise too: it has
    no pooled kernel)."""
    b, hq, d = q.shape
    hkv = k_pool.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_cross_attention: Hq={hq} not a multiple of Hkv={hkv}")
    if impl == "kernel":
        from repro_torch.kernels.swiftkv_decode import ops as kops
        return kops.swiftkv_decode(q, k_pool, v_pool, lengths, scale=scale,
                                   k_scale=k_scale, v_scale=v_scale, entries=entries)
    if impl == "naive":
        idx = entries.to(torch.int64)
        return decode_attention(
            q, k_pool[idx], v_pool[idx], lengths, impl="naive", scale=scale,
            k_scale=None if k_scale is None else k_scale[idx],
            v_scale=None if v_scale is None else v_scale[idx])
    if impl not in ("blockwise", "tokenwise"):
        raise NotImplementedError(
            f"decode_cross_attention: impl={impl!r} is not ported "
            "(kernel | tokenwise | blockwise | naive)")
    out = swiftkv.swiftkv_decode_pooled(q.reshape(b, hkv, hq // hkv, d), k_pool, v_pool,
                                        entries, lengths, k_scale, v_scale,
                                        block_size=block_size, scale=scale)
    return out.reshape(b, hq, d)


def decode_attention_ring(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          window: int, scale: float | None = None) -> torch.Tensor:
    """Sliding-window decode over a RING KV cache: the dense oracle.

    q: [B, Hq, D]; k/v_cache: [B, R, Hkv, D] with R >= window + 1 slots;
    ``lengths``: tokens seen so far (the newest token lives at slot
    (lengths-1) % R). Slot s holds absolute position p - ((p - s) mod R)
    where p = lengths-1; a slot is attended iff its position is in
    [lengths-window, lengths). R is ~window, independent of context."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    out = swiftkv.softmax_attention_reference(
        q.reshape(b, hkv, hq // hkv, d), k_cache, v_cache, lengths,
        window=window, ring=True, scale=scale)
    return out.reshape(b, hq, d)


def prefill_attention_ring(q: torch.Tensor, k_ring: torch.Tensor,
                           v_ring: torch.Tensor, q_positions: torch.Tensor,
                           p_max: int, *, window: int,
                           scale: float | None = None) -> torch.Tensor:
    """Causal SWA attention of a prompt chunk over a RING KV cache.

    q: [B, C, Hq, D], the chunk's queries at absolute positions
    ``q_positions`` [C]; k/v_ring: [B, R, Hkv, D] rings that already hold
    this chunk's keys (written at ``pos % R``) over the slot's history;
    ``p_max``: the last real (non-padding) position written. Slot ``s``
    holds position ``p_max - ((p_max - s) mod R)``; query row ``c`` attends
    it iff that position is in ``(q_positions[c] - window, q_positions[c]]``
    — which also masks slots a later in-chunk token overwrote (their lost
    position is out of the earlier query's window when R >= window + C -
    1, the engine's bound), a previous occupant's stale slots (negative
    position until this request wraps) and padded rows (never written).

    C and R are both small, so this materializes the [C, R] scores, as
    the reference does."""
    b, c, hq, d = q.shape
    r, hkv = k_ring.shape[1], k_ring.shape[2]
    g = hq // hkv
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s_idx = torch.arange(r, device=q.device)[None, :]                 # [1, R]
    pos = p_max - torch.remainder(p_max - s_idx, r)                   # [1, R]
    qp = q_positions.to(torch.int64)[:, None]                         # [C, 1]
    valid = (pos >= 0) & (pos <= qp) & (pos > qp - window)            # [C, R]
    qg = q.reshape(b, c, hkv, g, d).float()
    sc = torch.einsum("bchgd,brhd->bchgr", qg, k_ring.float()) * scale
    mask = valid[None, :, None, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    pr = torch.where(mask, torch.softmax(sc, dim=-1), 0.0)
    out = torch.einsum("bchgr,brhd->bchgd", pr, v_ring.float())
    return out.reshape(b, c, hq, d).to(q.dtype)


def _heads_constrain(x: torch.Tensor) -> torch.Tensor:
    """Pin [B, H, ...] activations to (batch over the batch axes, heads over
    the model axis), each where it divides the dim: the reshapes around GQA
    grouping would otherwise lose the head sharding. A no-op outside a
    distribution context and on a plain tensor."""
    return constrain_batch_model(x, 1)


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

    qh = _heads_constrain(q.transpose(1, 2))               # [B, Hq, Sq, D]
    kh = k.transpose(1, 2)                                  # [B, Hkv, Skv, D]
    vh = v.transpose(1, 2)
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    kh, vh = _heads_constrain(kh), _heads_constrain(vh)
    kw = dict(causal=causal, window=window, kv_block=kv_block, scale=scale)
    if is_dtensor(qh):
        out = _blockwise_local(qh, kh, vh, kv_lengths, q_offset, **kw)
    else:
        out = _blockwise(qh, kh, vh, kv_lengths, q_offset, **kw)
    return out.transpose(1, 2)


def _blockwise(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
               kv_lengths: torch.Tensor, q_offset: torch.Tensor, *, causal: bool,
               window: int | None, kv_block: int, scale: float) -> torch.Tensor:
    """:func:`prefill_attention`'s fold: qh [B, H, Sq, D], kh / vh [B, H,
    Skv, D] (KV heads repeated) -> [B, H, Sq, D] in q's dtype."""
    b, hq, sq, d = qh.shape
    skv = kh.shape[2]
    dev = qh.device
    qf = qh.float() * scale
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
    return state_finalize(state).to(qh.dtype)


def _blockwise_local(qh, kh, vh, kv_lengths: torch.Tensor, q_offset: torch.Tensor,
                     **kw):
    """:func:`_blockwise` on ``DTensor`` s, each process on its own (batch
    rows, heads) block: attention mixes neither, so the fold runs on the
    local tensors, with no collective, and the output is that block of the
    result (the reference's GSPMD partitions it the same way). Any other
    sharding of q, k and v (sequence, head dim, partial sums) is made
    replicated first; ``kv_lengths`` and ``q_offset`` (plain, or DTensors)
    are cut to the process's rows."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = qh.device_mesh
    qh = replicate_where(qh, lambda i, pl: not (pl.is_shard(0) or pl.is_shard(1)))
    want = qh.placements
    local = [t.redistribute(mesh, want).to_local() for t in (qh, kh, vh)]
    rows_pl = [pl if pl.is_shard(0) else Replicate() for pl in want]
    rows = [local_chunk(replicated_value(t), rows_pl, mesh) for t in (kv_lengths, q_offset)]
    out = _blockwise(*local, *rows, **kw)
    return DTensor.from_local(out, mesh, want, run_check=False, shape=qh.shape,
                              stride=torch.empty(qh.shape, device="meta").stride())
