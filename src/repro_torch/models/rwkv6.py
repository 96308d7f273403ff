"""RWKV6 ("Finch") time mix and channel mix: attention-free, with a
data-dependent decay. Port of ``repro.models.rwkv6``.

There is no KV cache and no softmax, so the paper's decode attention does
not apply: the WKV recurrence is itself a single-pass state update per
token, ``s <- w * s + k v^T`` with the output ``r . (s + u * k v^T)``,
and decode carries O(1) state per row: the token-shift carries
``x_prev_att`` / ``x_prev_ffn`` [B, d] and the WKV state [B, H, N, N]
(float32). The reference's simplifications are kept: static token-shift
mix coefficients, the data-dependent decay through a low-rank projection.

The reference scans the sequence in 64-token chunks, rematerialized so
that its backward pass stores one state per chunk; the port loops over
tokens in blocks of ``_BLOCK``, keeping a block's states to read every
token's output from them in one product, and under autograd checkpoints
each block. The float32 values are those of the reference's per-token
recurrence.

Under ``+w4a8`` serving ``wk``/``wv``/``wo`` go through ``layers.linear``'s
W4A8 form (they are in ``QUANT_KEYS``); ``wr``/``wg`` call ``linear`` on
dense weights, and the channel mix's ``fk``/``fv``/``fr`` are plain
products, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.context import get_context
from repro_torch.distributed.sharding import (from_local, is_dtensor, matmul_rows, merge_dims,
                                              split_dim, to_local)

from .layers import dense_init, linear, rms_norm, sigmoid, silu

_BLOCK = 64          # tokens whose WKV states a prefill keeps at once


class RWKVLayerState(NamedTuple):
    x_prev_att: torch.Tensor  # [B, d]
    x_prev_ffn: torch.Tensor  # [B, d]
    wkv: torch.Tensor         # [B, H, N, N] float32 (key dim x value dim)


def rwkv_layer_init(gen: torch.Generator, lead: tuple[int, ...], d_model: int,
                    d_ff: int, head_dim: int, *,
                    dtype: torch.dtype = torch.float32) -> dict:
    """One RWKV6 layer's parameters (stacked over ``lead``), in the
    reference's tree layout. ``dtype`` stores the projection matrices; the
    mix coefficients, the base decay ``w0``, the bonus ``u`` and the group
    norm weight ``ln_x`` stay float32."""
    h = d_model // head_dim
    lr = max(32, d_model // 16)       # low-rank width of the decay projection
    dev = gen.device
    full = lambda shape, v: torch.full((*lead, *shape), v, dtype=torch.float32, device=dev)
    dense = lambda k, n: dense_init(gen, (*lead, k, n), dtype=dtype)
    return {
        # time mix
        "mix_rkvwg": full((5, d_model), 0.5),
        "wr": dense(d_model, d_model), "wk": dense(d_model, d_model),
        "wv": dense(d_model, d_model), "wg": dense(d_model, d_model),
        "wo": dense(d_model, d_model),
        "w0": full((d_model,), -6.0),                  # base decay
        "w_a": dense(d_model, lr), "w_b": dense(lr, d_model),
        "u": full((h, head_dim), 0.0),                 # current-token bonus
        "ln_x": full((d_model,), 1.0),                 # per-head group norm
        # channel mix
        "mix_ffn": full((2, d_model), 0.5),
        "fk": dense(d_model, d_ff), "fv": dense(d_ff, d_model),
        "fr": dense(d_model, d_model),
    }


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), float32. The reference multiplies a
    compute-dtype ``xw`` by its float32 ``w_a``, which JAX promotes to
    float32; the port upcasts both. Its products, as the channel mix's, go
    through ``sharding.matmul_rows`` (``x @ w`` on plain tensors): on a
    sequence-sharded ``DTensor`` torch 2.13 plans a product's strided
    shard by a search that took ~60 s an op on a 2 x 16 x 16 mesh."""
    lr = matmul_rows(torch.tanh(matmul_rows(xw.float(), p["w_a"].float())), p["w_b"].float())
    return torch.exp(-torch.exp(p["w0"].float() + lr))


def _wkv_block(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor, grad: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of tokens, time-major ([T, B, H, N]), from ``state``: (y
    [T, B, H, N], the block's last state). One ``addcmul`` a token for the
    states, then every output in one product. Without a gradient each state
    is written into one buffer (``out=``); with one (``grad``; autograd
    refuses ``out=``), the same ``addcmul`` makes each state and the states
    are stacked: the same values."""
    kv = k[..., :, None] * v[..., None, :]                        # [T, B, H, N, N]
    wt = w[..., :, None]
    if grad:
        states = [state]
        for t in range(kv.shape[0]):
            states.append(torch.addcmul(kv[t], wt[t], states[t]))
        states = torch.stack(states)
    else:
        states = torch.empty((kv.shape[0] + 1, *state.shape), dtype=torch.float32,
                             device=r.device)
        states[0] = state
        for t in range(kv.shape[0]):
            torch.addcmul(kv[t], wt[t], states[t], out=states[t + 1])
    inner = torch.addcmul(states[:-1], u[:, :, None], kv)
    return torch.einsum("tbhn,tbhnm->tbhm", r, inner), states[-1]


def _wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence over a sequence, float32. r, k, v, w: [B, S, H, N];
    u: [H, N]; s0: [B, H, N, N]. Returns (y [B, S, H, N], final state).

    Token t reads ``y_t = r_t . (s_{t-1} + u * k_t v_t^T)`` and updates
    ``s_t = w_t * s_{t-1} + k_t v_t^T``, in blocks of ``_BLOCK`` tokens
    (:func:`_wkv_block`). When autograd records, each block is
    rematerialized in backward, as the reference remats its 64-token
    chunk: backward keeps one state per block, not one per token."""
    s = r.shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0))
    t_major = lambda a: a.transpose(0, 1)                      # [S, B, H, N]
    r, k, v, w = map(t_major, (r, k, v, w))
    ys, state = [], s0
    for lo in range(0, s, _BLOCK):
        blk = (r[lo:lo + _BLOCK], k[lo:lo + _BLOCK], v[lo:lo + _BLOCK], w[lo:lo + _BLOCK],
               u, state)
        if grad:
            y, state = checkpoint(_wkv_block, *blk, True, use_reentrant=False)
        else:
            y, state = _wkv_block(*blk, False)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), state


def _wkv_scan_sharded(r, k, v, w, u, s0):
    """:func:`_wkv_scan` on ``DTensor`` s under a distribution context, each
    process on its (batch rows, heads) block: the recurrence mixes neither,
    so it runs on the local tensors, with no collective, and the outputs
    are that block of the result. Batch rows go over the batch axes and
    heads over the model axis where each divides its dim (else the dim is
    whole on every process, and so is its gradient); u's gradient is
    partial over the batch axes that split the rows. DTensor's own einsum
    fails on a head dim its view cut unevenly (rwkv6-3b's 40 heads over
    16)."""
    ctx = get_context()
    batch = ctx.batch_axes if r.shape[0] % ctx.axis_size(ctx.batch_axes) == 0 else None
    heads = ctx.model_axis if r.shape[2] % ctx.axis_size(ctx.model_axis) == 0 else None
    rows_h, state = (batch, None, heads, None), (batch, heads, None, None)
    ys, s_fin = _wkv_scan(*(to_local(t, rows_h) for t in (r, k, v, w)),
                          to_local(u, (heads, None), partial_over=batch or ()),
                          to_local(s0, state))
    return from_local(ys, rows_h, r.shape), from_local(s_fin, state, s0.shape)


def rwkv_time_mix(p: dict, x: torch.Tensor, state: RWKVLayerState, head_dim: int,
                  n_valid: int | None = None
                  ) -> tuple[torch.Tensor, RWKVLayerState]:
    """x: [B, S, d] -> (y, new state), seeded from ``state`` (a zero state
    is a prefill from scratch; a carried one continues a chunked prefill).

    ``n_valid``: positions >= n_valid are padding and exact state no-ops
    (k = 0 kills the kv update, w = 1 keeps the decay the identity, and the
    token-shift carry is taken at n_valid - 1), so a right-padded last chunk
    leaves the state an unpadded one would."""
    _, s, d = x.shape
    dt = x.dtype
    h = d // head_dim
    x_prev = torch.cat([state.x_prev_att[:, None, :], x[:, :-1, :]], dim=1)
    mix = p["mix_rkvwg"].to(dt)                                  # [5, d]
    xr, xk, xv, xw, xg = (x * mix[i] + x_prev * (1 - mix[i]) for i in range(5))
    heads = (h, head_dim)
    r = split_dim(linear(p, "wr", xr).to(dt), -1, heads)
    k = split_dim(linear(p, "wk", xk).to(dt), -1, heads)
    v = split_dim(linear(p, "wv", xv).to(dt), -1, heads)
    g = silu(linear(p, "wg", xg).to(dt))
    w = split_dim(_decay(p, xw), -1, heads)                      # f32
    if n_valid is not None:
        valid = (torch.arange(s, device=x.device) < n_valid)[None, :, None, None]
        k = torch.where(valid, k, 0.0)
        w = torch.where(valid, w, 1.0)
    scan = _wkv_scan_sharded if is_dtensor(r) and get_context().active else _wkv_scan
    ys, s_fin = scan(r.float(), k.float(), v.float(), w, p["u"].float(), state.wkv.float())
    y = merge_dims(ys, 2).to(dt)
    y = rms_norm(y, p["ln_x"]) * g
    y = linear(p, "wo", y).to(dt)
    x_last = x[:, -1 if n_valid is None else n_valid - 1, :]
    return y, RWKVLayerState(x_prev_att=x_last, x_prev_ffn=state.x_prev_ffn, wkv=s_fin)


def _channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    mix = p["mix_ffn"].to(dt)
    xk = x * mix[0] + x_prev * (1 - mix[0])
    xr = x * mix[1] + x_prev * (1 - mix[1])
    k = torch.square(F.relu(matmul_rows(xk, p["fk"].to(dt))))
    return sigmoid(matmul_rows(xr, p["fr"].to(dt))) * matmul_rows(k, p["fv"].to(dt))


def rwkv_channel_mix(p: dict, x: torch.Tensor, state: RWKVLayerState,
                     n_valid: int | None = None
                     ) -> tuple[torch.Tensor, RWKVLayerState]:
    """x: [B, S, d]; the token-shift carry is taken at ``n_valid - 1``."""
    x_prev = torch.cat([state.x_prev_ffn[:, None, :], x[:, :-1, :]], dim=1)
    x_last = x[:, -1 if n_valid is None else n_valid - 1, :]
    return _channel_mix(p, x, x_prev), state._replace(x_prev_ffn=x_last)


def rwkv_time_mix_step(p: dict, x_t: torch.Tensor, state: RWKVLayerState,
                       head_dim: int, active: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, RWKVLayerState]:
    """Decode: x_t [B, d], one token, an O(1) state update. r, k and v go
    from the projection straight to float32 (the prefill rounds them to the
    compute dtype first), as in the reference.

    ``active``: optional [B] bool, the ragged batch: inactive rows carry
    ``x_prev_att`` and ``wkv`` through unchanged (``decode_multi`` relies on
    it when a row retires inside a block)."""
    d = x_t.shape[-1]
    dt = x_t.dtype
    h = d // head_dim
    mix = p["mix_rkvwg"].to(dt)
    xp = state.x_prev_att
    xr, xk, xv, xw, xg = (x_t * mix[i] + xp * (1 - mix[i]) for i in range(5))
    heads = (h, head_dim)
    r = split_dim(linear(p, "wr", xr).float(), -1, heads)
    k = split_dim(linear(p, "wk", xk).float(), -1, heads)
    v = split_dim(linear(p, "wv", xv).float(), -1, heads)
    g = silu(linear(p, "wg", xg).to(dt))
    w = split_dim(_decay(p, xw), -1, heads)
    kv = k[..., :, None] * v[..., None, :]                       # [B, H, N, N]
    y = torch.einsum("bhn,bhnm->bhm", r,
                     torch.addcmul(state.wkv, p["u"].float()[:, :, None], kv))
    s_new = torch.addcmul(kv, w[..., None], state.wkv)
    y = rms_norm(merge_dims(y, 1).to(dt), p["ln_x"]) * g
    att_new, wkv_new = x_t, s_new
    if active is not None:
        att_new = torch.where(active[:, None], att_new, state.x_prev_att)
        wkv_new = torch.where(active[:, None, None, None], wkv_new, state.wkv)
    return linear(p, "wo", y).to(dt), state._replace(x_prev_att=att_new, wkv=wkv_new)


def rwkv_channel_mix_step(p: dict, x_t: torch.Tensor, state: RWKVLayerState,
                          active: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, RWKVLayerState]:
    """Decode form of the channel mix; inactive rows keep their
    ``x_prev_ffn`` carry."""
    out = _channel_mix(p, x_t, state.x_prev_ffn)
    ffn_new = x_t if active is None else torch.where(active[:, None], x_t,
                                                     state.x_prev_ffn)
    return out, state._replace(x_prev_ffn=ffn_new)
