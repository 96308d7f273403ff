"""Plain PyTorch versions of the SwiftKV decode kernel.

``swiftkv_decode_ref`` is the dense two-pass softmax oracle (materializes
scores — exactly what the kernel avoids), extended to int8 caches with
per-position scales and to ring caches (masked by each slot's position).
``swiftkv_decode_split_ref`` models the kernel's fold order: its split of
the positions over CTAs, and inside a CTA its warps', lane groups' and
batches' share of the rows, with partial states merged in the kernel's
order (a ring's chunks are cut in position space and read at ``t mod S``,
as the kernel reads them); only tests and the chip smoke test use it.
``swiftkv_decode_mma_ref`` models the GQA form on tensor cores
(``csrc/swiftkv_decode_mma.cu``) the same way: its tiles of 64 positions,
a warp's 16 of each folded with one max and one rescale, scores in log2
units, P in a high and a low bf16 part, and its merge order.

``entries=`` (all three): the caches are a source-KV pool ``[E, S, Hkv,
D]`` (int8 scales ``[E, Hkv, S]``) and row ``b`` reads entry
``entries[b]``, as the kernels read it in place: each function is the same
function on the gathered per-row copy ``k[entries]``.

``exp_mode="lut"`` is the paper's Eq. 9-10 exponential in its kernel form
(:func:`exp_lut_kernel`, the reference kernel's ``_exp_lut``): every
exponential of the fold, and of the merge of split states, goes through it.
"""
from __future__ import annotations

import torch

from repro_torch.core.exp2_lut import FLT_MIN, LOG2_E, exp2_frac_lut
from repro_torch.core.swiftkv import (NEG_INF, SwiftKVState, _valid_positions,
                                      dequantize_cache, softmax_attention_reference,
                                      state_finalize, state_init, state_merge,
                                      state_update_block)

WARPS = 4        # warps of a CTA (kWarps)
WARP_ROWS = 8    # cache rows a warp folds per step (kWarpRows)
TILE = WARPS * WARP_ROWS   # positions per CTA step of the kernel (kTile)
MMA_WARP_ROWS = 16         # the GQA form's positions per warp per step (kRows)
MMA_TILE = WARPS * MMA_WARP_ROWS   # its positions per CTA step (kTile)
EXP_MODES = ("native", "lut")


def exp_lut_kernel(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for float32 x <= 0 as the reference kernel computes it
    (``kernel.py::_exp_lut``): ``n = ceil(x log2 e)`` clamped to [-126, 0],
    2^n built from exponent bits, 2^f from the LUT with one fused
    multiply-add, and a subnormal product flushed to 0 (XLA flushes on the
    CPU and the TPU). Because of the clamp, ``exp_lut_kernel(-1e30)`` is
    2^-126, not 0: a masked position must be zeroed by a select."""
    y = x * LOG2_E
    n = torch.ceil(y)
    frac = exp2_frac_lut(y - n)
    pow2n = ((n.clamp(-126, 0) + 127).to(torch.int32) << 23).view(torch.float32)
    out = frac * pow2n
    return torch.where(out < FLT_MIN, 0.0, out)


def _exp(exp_mode: str):
    if exp_mode not in EXP_MODES:
        raise ValueError(f"swiftkv_decode: exp_mode must be 'native' or 'lut', "
                         f"got {exp_mode!r}")
    return exp_lut_kernel if exp_mode == "lut" else torch.exp


def gather_entries(entries: torch.Tensor | None, *planes):
    """The per-row copy of pool planes (``[E, ...]``) that rows read:
    ``plane[entries]`` for each plane (None stays None); with no
    ``entries`` the planes themselves."""
    if entries is None:
        return planes
    idx = entries.to(torch.int64)
    return tuple(None if p is None else p[idx] for p in planes)


def swiftkv_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor, *,
                       window: int | None = None, scale: float | None = None,
                       ring: bool = False, exp_mode: str = "native",
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       entries: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B]; k_scale /
    v_scale: optional [B, Hkv, S] scales of an int8 cache -> [B, Hq, D].
    ``ring``: the caches are rings of S slots (``lengths`` counts the
    tokens seen; slot s holds position ``p - ((p - s) mod S)``, p =
    lengths - 1, and attends iff that position is >= 0 and > p - window).
    ``exp_mode="lut"``: the whole cache folded as one block with
    :func:`exp_lut_kernel` (the dense softmax with the LUT exponential).
    ``entries``: [B], the caches are a pool read one entry per row."""
    exp = _exp(exp_mode)
    k_cache, v_cache, k_scale, v_scale = gather_entries(entries, k_cache, v_cache,
                                                        k_scale, v_scale)
    b, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale)
        v_cache = dequantize_cache(v_cache, v_scale)
    qg = q.reshape(b, hkv, hq // hkv, d)
    if exp_mode == "native":
        out = softmax_attention_reference(qg, k_cache, v_cache, lengths,
                                          window=window, ring=ring, scale=scale)
        return out.reshape(b, hq, d)
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    valid = _valid_positions(torch.arange(s_len, device=q.device),
                             lengths.to(torch.int64), window,
                             s_len if ring else None).float()[:, None, None, :]
    state = state_update_block(state_init(d, s.shape[:3], device=q.device), s,
                               v_cache.float().permute(0, 2, 1, 3)[:, :, None],
                               valid, exp=exp)
    return state_finalize(state).reshape(b, hq, d).to(q.dtype)


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
                             window: int | None = None,
                             scale: float | None = None, ring: bool = False,
                             exp_mode: str = "native",
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None,
                             entries: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's fold in plain PyTorch, in the kernel's order: the
    chunks of :func:`chunk_bounds` (one per CTA of a cluster), each cut as
    the kernel cuts it — tile step j, warp w's rows w*8 .. w*8+7 of the
    tile, lane group g's rows g, g + n_groups, ... of those, folded a batch
    of 4 rows (2 at G > 4) at a time with one max and one rescale — then
    the partial states merged as the kernel merges them: lane groups by
    butterfly, warps in order, chunks in split order; then the one deferred
    division. Shapes as :func:`swiftkv_decode_ref`. The order matters for
    ``exp_mode="lut"``, where exp(a) exp(b) and exp(a + b) differ by up to
    the LUT's error (~6e-5): it puts every exponential of the kernel's
    fold and merges on the same argument. ``ring``: the ring is read at
    ``t mod S`` for positions ``t`` (:func:`unroll_ring`) and split as the
    linear cache holding those positions, with window ``min(window, S)``:
    the kernel's ring and linear forms fold the same rows in the same
    order. ``entries``: as :func:`swiftkv_decode_ref`."""
    exp = _exp(exp_mode)
    k, v, k_scale, v_scale = gather_entries(entries, k, v, k_scale, v_scale)
    if ring:
        s_len = k.shape[1]
        k, v = unroll_ring(k, lengths, 1), unroll_ring(v, lengths, 1)
        if k_scale is not None:
            k_scale = unroll_ring(k_scale, lengths, 2)
            v_scale = unroll_ring(v_scale, lengths, 2)
        return swiftkv_decode_split_ref(q, k, v, lengths, n_split=n_split,
                                        window=min(window, s_len), scale=scale,
                                        exp_mode=exp_mode, k_scale=k_scale,
                                        v_scale=v_scale)
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = (1.0 / d ** 0.5) if scale is None else scale
    # the kernel's lane groups: pow2ceil(D / 8) lanes per row, so n_groups
    # rows of a warp's 8 at a time; batches of 4 rows (2 at G > 4)
    lanes = 1 << max(0, (d // 8 - 1).bit_length())
    n_groups = 32 // lanes
    rows = max(1, WARP_ROWS // n_groups)             # a lane group's rows of a step
    batch = 2 if g > 4 else 4
    n_batches = -(-rows // batch)
    kf = dequantize_cache(k, k_scale)
    vf = dequantize_cache(v, v_scale)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(b, hkv, g, d).float(), kf) * scale
    bounds = chunk_bounds(lengths, s_len, n_split=n_split, window=window)
    start = torch.stack([c[0] for c in bounds], 1)[:, :, None, None, None]   # [B, n, 1, 1, 1]
    end = torch.stack([c[1] for c in bounds], 1)[:, :, None, None, None]
    tile0 = start // TILE * TILE        # a live chunk's first tile
    n_steps = int(torch.where(end > start, -(-end // TILE) - start // TILE, 0).max())
    warp = torch.arange(WARPS, device=dev)[:, None, None]
    group = torch.arange(n_groups, device=dev)[:, None]
    shape = (b, hkv, g, n_split, WARPS, n_groups)
    mu = torch.full(shape, NEG_INF, device=dev)
    z = torch.zeros(shape, device=dev)
    y = torch.zeros((*shape, d), device=dev)
    for step in range(n_steps * n_batches):
        j, i0 = divmod(step, n_batches)
        i = i0 * batch + torch.arange(batch, device=dev)             # [batch]
        r = group + i * n_groups                                     # [n_groups, batch]
        t = tile0 + j * TILE + warp * WARP_ROWS + r                  # [B, n, W, n_groups, batch]
        ok = (i < rows) & (r < WARP_ROWS) & (t >= start) & (t < end)
        flat = t.clamp(0, s_len - 1).reshape(b, -1)
        st = s.gather(3, flat[:, None, None].expand(b, hkv, g, -1)).reshape(*s.shape[:3], *t.shape[1:])
        vt = vf[torch.arange(b, device=dev)[:, None], flat]          # [B, N, Hkv, D]
        vt = vt.permute(0, 2, 1, 3).reshape(b, hkv, 1, *t.shape[1:], d)
        ok = ok[:, None, None]
        m = torch.maximum(mu, torch.where(ok, st, NEG_INF).amax(-1))
        alpha = exp(mu - m)
        p = torch.where(ok, exp(st - m[..., None]), 0.0)
        z = alpha * z + p.sum(-1)
        y = alpha[..., None] * y + (p[..., None] * vt).sum(-2)
        mu = m
    state = SwiftKVState(mu, z, y)
    o = 1
    while o < n_groups:                 # lane groups: butterfly (xor) merges
        swap = torch.arange(n_groups, device=dev) ^ o
        state = state_merge(state, _part(state, swap), exp=exp)
        o <<= 1
    state = _merge_in_order(_part(state, 0), 2, exp)   # [B, Hkv, G]
    return state_finalize(state).reshape(b, hq, d).to(q.dtype)


def _part(state: SwiftKVState, idx) -> SwiftKVState:
    """The partial states at ``idx`` of the last state axis."""
    return SwiftKVState(state.mu[..., idx], state.z[..., idx], state.y[..., idx, :])


def _merge_in_order(state: SwiftKVState, n_axes: int, exp) -> SwiftKVState:
    """Fold the last ``n_axes`` state axes away, the last first (warps, then
    splits), each in index order, as the kernels merge them."""
    for _ in range(n_axes):
        acc = _part(state, 0)
        for i in range(1, state.mu.shape[-1]):
            acc = state_merge(acc, _part(state, i), exp=exp)
        state = acc
    return state


def swiftkv_decode_mma_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, n_split: int,
                           window: int | None = None, scale: float | None = None,
                           ring: bool = False, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           entries: torch.Tensor | None = None) -> torch.Tensor:
    """The GQA form's fold (``csrc/swiftkv_decode_mma.cu``) in plain
    PyTorch, in its order: the chunks of :func:`chunk_bounds` with tiles of
    ``MMA_TILE`` positions (one chunk per CTA of a cluster); in a chunk,
    tile step j, warp w's rows w*16 .. w*16+15 of the tile, folded with one
    max and one rescale per step; scores ``(q . k) * (scale * log2 e)`` (an
    int8 cache's k scale after), so every exponential is ``exp2``; the
    weight of v (times an int8 cache's v scale) in two bf16 parts, high and
    low, as the kernel feeds them to its tensor cores, Z from the f32
    weights; then warps merged in order, chunks in split order, and one
    deferred division. Shapes as :func:`swiftkv_decode_ref`; the kernel
    takes a bf16 q, the model any float q. ``ring`` and ``entries``: as
    :func:`swiftkv_decode_split_ref`."""
    k, v, k_scale, v_scale = gather_entries(entries, k, v, k_scale, v_scale)
    if ring:
        s_len = k.shape[1]
        k, v = unroll_ring(k, lengths, 1), unroll_ring(v, lengths, 1)
        if k_scale is not None:
            k_scale = unroll_ring(k_scale, lengths, 2)
            v_scale = unroll_ring(v_scale, lengths, 2)
        return swiftkv_decode_mma_ref(q, k, v, lengths, n_split=n_split,
                                      window=min(window, s_len), scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = (1.0 / d ** 0.5) if scale is None else scale
    f32 = torch.float32        # scale x log2 e rounded in f32, as the launcher does
    scale_log2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2_E, dtype=f32)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(b, hkv, g, d).float(), k.float())
    s = s * scale_log2.to(dev)
    v_sc = torch.ones((b, hkv, s_len), device=dev)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
        v_sc = v_scale.float()
    vf = v.float()
    bounds = chunk_bounds(lengths, s_len, n_split=n_split, tile=MMA_TILE, window=window)
    start = torch.stack([c[0] for c in bounds], 1)[:, :, None, None]   # [B, n, 1, 1]
    end = torch.stack([c[1] for c in bounds], 1)[:, :, None, None]
    tile0 = start // MMA_TILE * MMA_TILE
    n_steps = int(torch.where(end > start, -(-end // MMA_TILE) - start // MMA_TILE, 0).max())
    rows = (torch.arange(WARPS, device=dev)[:, None] * MMA_WARP_ROWS
            + torch.arange(MMA_WARP_ROWS, device=dev))                # [W, 16]
    shape = (b, hkv, g, n_split, WARPS)
    mu = torch.full(shape, NEG_INF, device=dev)
    z = torch.zeros(shape, device=dev)
    y = torch.zeros((*shape, d), device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    for j in range(n_steps):
        t = tile0 + j * MMA_TILE + rows                               # [B, n, W, 16]
        ok = ((t >= start) & (t < end))[:, None, None]                # [B, 1, 1, n, W, 16]
        flat = t.clamp(0, s_len - 1).reshape(b, -1)
        x = s.gather(3, flat[:, None, None].expand(b, hkv, g, -1)).reshape(*s.shape[:3], *t.shape[1:])
        x = torch.where(ok, x, NEG_INF)
        m = torch.maximum(mu, x.amax(-1))
        alpha = torch.exp2(mu - m)
        p = torch.where(ok, torch.exp2(x - m[..., None]), 0.0)
        z = alpha * z + p.sum(-1)
        w = p * v_sc.gather(2, flat[:, None].expand(b, hkv, -1)).reshape(b, hkv, 1, *t.shape[1:])
        w_hi = w.to(torch.bfloat16).float()
        w_lo = (w - w_hi).to(torch.bfloat16).float()
        vt = vf[bidx, flat].reshape(b, *t.shape[1:], hkv, d).permute(0, 4, 1, 2, 3, 5)
        vt = vt[:, :, None]                                          # [B, Hkv, 1, n, W, 16, D]
        y = (alpha[..., None] * y + (w_hi[..., None] * vt).sum(-2)
             + (w_lo[..., None] * vt).sum(-2))
        mu = m
    state = _merge_in_order(SwiftKVState(mu, z, y), 2, torch.exp2)
    return state_finalize(state).reshape(b, hq, d).to(q.dtype)


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
