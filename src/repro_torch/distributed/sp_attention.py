"""Sequence-parallel SwiftKV decode attention. Port of
``repro.distributed.sp_attention``.

The KV cache shards along its *sequence* over the model axis; each process
folds its slice with the single-pass blockwise recurrence into a partial
``(mu, Z, Y)`` state, one small all-gather brings every slice's state to
every process, and the associative ``state_merge`` in slice order gives
the exact attention output. A process sends ``B_loc * Hq * (D + 2)``
float32 values a call, whatever the context length: the cache never moves.

The reference runs this under ``shard_map``; under ``torch.distributed``
each process runs the shard function itself. An argument that is a
``DTensor`` on the mesh gives its local shard (the caches ``Shard(1)`` on
the sequence axis, the batch ``Shard(0)`` on the batch axes or
replicated); a plain tensor counts as replicated, and the process takes
its own slice of the sequence (a view, no copy). The fold and the merge
are plain PyTorch, as the reference's are plain ``jnp``: no kernel.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import swiftkv
from repro_torch.core.swiftkv import SwiftKVState, state_finalize, state_merge

from .context import COLLECTIVES, DistContext


def _local_partial_state(q: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor,
                         lengths: torch.Tensor, shard_offset: int, *,
                         window: int | None, block_size: int,
                         scale: float) -> SwiftKVState:
    """One process's fold over its KV slice. q: [B, Hkv, G, D]; k_loc, v_loc:
    [B, S_loc, Hkv, D]; lengths: [B] global valid prefixes. Position ``t``
    of the slice is global position ``shard_offset + t``. The last block is
    cut at S_loc, so no padding row enters the fold. Returns the state with
    batch shape [B, Hkv, G]. Every block is folded (no host read of
    ``lengths``): blocks past a row's prefix fold nothing."""
    b, hkv, g, d = q.shape
    s_loc = k_loc.shape[1]
    lengths = lengths.to(torch.int64)[:, None]
    qf = q.float()
    state = swiftkv.state_init(d, (b, hkv, g), device=q.device)
    for start in range(0, s_loc, block_size):
        stop = min(start + block_size, s_loc)
        t = shard_offset + torch.arange(start, stop, device=q.device)     # global pos
        valid = t[None] < lengths
        if window is not None:
            valid &= t[None] >= lengths - window
        k_blk = k_loc[:, start:stop].float()
        v_blk = v_loc[:, start:stop].float()
        s_blk = torch.einsum("bhgd,bshd->bhgs", qf, k_blk) * scale
        state = swiftkv.state_update_block(state, s_blk, v_blk.permute(0, 2, 1, 3)[:, :, None],
                                           valid.float()[:, None, None, :])
    return state


def _local(x, mesh):
    if hasattr(x, "to_local"):
        if x.device_mesh != mesh:
            raise ValueError("decode_attention_sp: a DTensor on another mesh")
        return x.to_local(), True
    return x, False


def decode_attention_sp(q, k_cache, v_cache, lengths, *, mesh, seq_axes,
                        window: int | None = None, block_size: int = 512,
                        scale: float | None = None):
    """q: [B, Hq, D]; caches [B, S, Hkv, D] with S sharded over ``seq_axes``
    (one mesh axis); lengths [B]. The batch is sharded where the arguments
    are (``DTensor``s ``Shard(0)`` on the batch axes), else every process
    folds every row. Returns [B, Hq, D], placed as ``q`` (a ``DTensor``
    with q's placements when q is one)."""
    if not isinstance(seq_axes, str):
        if len(seq_axes) != 1:
            raise NotImplementedError("decode_attention_sp: one sequence axis")
        seq_axes = seq_axes[0]
    ctx = DistContext(mesh=mesh, model_axis=seq_axes)
    q_l, q_dt = _local(q, mesh)
    k_l, k_dt = _local(k_cache, mesh)
    v_l, _ = _local(v_cache, mesh)
    len_l, _ = _local(lengths, mesh)
    n_shards = ctx.axis_size(seq_axes)
    idx = ctx.axis_index(seq_axes)
    s_len = k_cache.shape[1]                      # global, for a DTensor too
    if s_len % n_shards:
        raise ValueError(f"decode_attention_sp: S={s_len} not divisible by {n_shards} shards")
    s_loc = s_len // n_shards
    if k_dt:
        if k_l.shape[1] != s_loc:
            raise ValueError("decode_attention_sp: the caches must be Shard(1) on the "
                             "sequence axis")
    else:
        k_l = k_l[:, idx * s_loc:(idx + 1) * s_loc]
        v_l = v_l[:, idx * s_loc:(idx + 1) * s_loc]
    b, hq, d = q_l.shape
    hkv = k_l.shape[2]
    g = hq // hkv
    scale = (1.0 / d ** 0.5) if scale is None else scale
    st = _local_partial_state(q_l.reshape(b, hkv, g, d), k_l, v_l, len_l, idx * s_loc,
                              window=window, block_size=block_size, scale=scale)
    # the slices' partial states, all gathered over the sequence axis
    packed = torch.cat([st.mu[..., None], st.z[..., None], st.y], dim=-1)   # [B, Hkv, G, D+2]
    parts = [torch.empty_like(packed) for _ in range(n_shards)]
    dist.all_gather(parts, packed, group=mesh.get_group(seq_axes))
    COLLECTIVES["sp_all_gather"] += 1
    COLLECTIVES["sp_all_gather_bytes"] += packed.numel() * packed.element_size()
    unpack = lambda x: SwiftKVState(mu=x[..., 0], z=x[..., 1], y=x[..., 2:])
    acc = unpack(parts[0])
    for part in parts[1:]:                         # in slice order, as the reference
        acc = state_merge(acc, unpack(part))
    out = state_finalize(acc).to(q_l.dtype).reshape(b, hq, d)
    if q_dt:
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, mesh, q.placements, run_check=False)
    return out
