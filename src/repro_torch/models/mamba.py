"""Selective SSM (Mamba-style) branch of the hybrid (hymba) layers. Port of
``repro.models.mamba``.

A block: in-projection -> causal depthwise conv -> SiLU -> selective scan
(data-dependent dt, B, C; diagonal A) -> gate -> out-projection. Decode
carries O(1) state per row, the conv's last K - 1 inputs and the SSM state
[d_inner, N], both float32: no KV cache.

The numerics follow the reference's: the sequence form computes the conv
in x's dtype as a sum over the K taps starting from 0, the decode step in
float32 on a float32 window; dt is float32 from the float32 ``dt_w`` and
``dt_bias``; the scan runs in float32. The scan loops over tokens in blocks
of ``_BLOCK`` (one launch a token), keeping a block's states to read every
token's output from them in one product; under autograd each block is
checkpointed (the reference's scan has no remat: the values are the
same).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.context import get_context
from repro_torch.distributed.sharding import from_local, is_dtensor, matmul_rows, to_local

from .layers import dense_init, silu, softplus

_BLOCK = 64          # tokens whose SSM states a prefill keeps at once


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, K-1, d_inner] float32: the conv's trailing inputs
    ssm: torch.Tensor   # [B, d_inner, N] float32


def mamba_init(gen: torch.Generator, lead: tuple[int, ...], d_model: int, *,
               state: int = 16, conv: int = 4, expand: int = 2,
               dtype: torch.dtype = torch.float32) -> dict:
    """One Mamba branch's parameters (stacked over ``lead``), in the
    reference's tree layout. ``dtype`` stores the three projections;
    ``conv_w``, ``dt_w``, ``dt_bias``, ``a_log`` and ``d_skip`` stay
    float32."""
    d_inner = expand * d_model
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    a_log = torch.log(torch.arange(1, state + 1, **f32)).expand(*lead, d_inner, state)
    return {
        "in_proj": dense_init(gen, (*lead, d_model, 2 * d_inner), dtype=dtype),
        "conv_w": torch.randn((*lead, conv, d_inner), generator=gen, **f32)
                  * (1.0 / conv) ** 0.5,
        "x_proj": dense_init(gen, (*lead, d_inner, 1 + 2 * state), dtype=dtype),  # dt, B, C
        "dt_bias": torch.zeros((*lead, d_inner), **f32),
        "dt_w": dense_init(gen, (*lead, 1, d_inner))[..., 0, :],                   # dt broadcast
        "a_log": a_log.contiguous(),                                                # [d_inner, N]
        "d_skip": torch.ones((*lead, d_inner), **f32),
        "out_proj": dense_init(gen, (*lead, d_inner, d_model), dtype=dtype),
    }


def _dt(params: dict, dbc: torch.Tensor) -> torch.Tensor:
    """The discretization step, float32: softplus of the dt column times
    ``dt_w`` plus ``dt_bias``."""
    return softplus(dbc[..., :1].float() * params["dt_w"].float()
                    + params["dt_bias"].float())


def _ssm_block(a: torch.Tensor, u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, h: torch.Tensor, grad: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of tokens, time-major (u, dt [T, B, d_inner]; bmat, cmat
    [T, B, N]), from state ``h``: (y [T, B, d_inner], the block's last
    state). Without a gradient each state is written into one buffer
    (``out=``); with one (``grad``; autograd refuses ``out=``), the same
    ``addcmul`` makes each state and the states are stacked: the same
    values."""
    da = torch.exp(dt[..., None] * a)                             # [T, B, d_inner, N]
    dbx = (dt * u)[..., None] * bmat[:, :, None, :]
    if grad:
        states = [h]
        for t in range(da.shape[0]):
            states.append(torch.addcmul(dbx[t], da[t], states[t]))
        states = torch.stack(states)
    else:
        states = torch.empty((da.shape[0] + 1, *h.shape), dtype=torch.float32,
                             device=u.device)
        states[0] = h
        for t in range(da.shape[0]):
            torch.addcmul(dbx[t], da[t], states[t], out=states[t + 1])
    return torch.einsum("tbdn,tbn->tbd", states[1:], cmat), states[-1]


def _ssm_scan(a: torch.Tensor, u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan, float32. a: [d_inner, N] (= -exp(a_log)); u, dt:
    [B, S, d_inner]; bmat, cmat: [B, S, N]; h0: [B, d_inner, N]. Token t:
    ``h_t = exp(dt_t a) * h_{t-1} + (dt_t u_t) b_t^T`` and ``y_t = h_t c_t``,
    in blocks of ``_BLOCK`` tokens (:func:`_ssm_block`), each
    rematerialized in backward when autograd records. Returns (y [B, S,
    d_inner], final state)."""
    s = u.shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (a, u, dt, bmat, cmat, h0))
    t_major = lambda x: x.transpose(0, 1)
    u, dt, bmat, cmat = map(t_major, (u, dt, bmat, cmat))
    ys, h = [], h0
    for lo in range(0, s, _BLOCK):
        blk = (a, u[lo:lo + _BLOCK], dt[lo:lo + _BLOCK], bmat[lo:lo + _BLOCK],
               cmat[lo:lo + _BLOCK], h)
        if grad:
            y, h = checkpoint(_ssm_block, *blk, True, use_reentrant=False)
        else:
            y, h = _ssm_block(*blk, False)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), h


def _ssm_scan_sharded(a, u, dt, bmat, cmat, h0):
    """:func:`_ssm_scan` on ``DTensor`` s under a distribution context, each
    process on its (batch rows, channels) block: the scan mixes neither
    (b and c are shared by a row's channels), so it runs on the local
    tensors, with no collective, and the outputs are that block of the
    result. a's gradient is partial over the batch axes, b's and c's over
    the model axis."""
    ctx = get_context()
    batch, model = ctx.batch_axes, ctx.model_axis
    rows_ch = (batch, None, model)
    ys, h = _ssm_scan(to_local(a, (model, None), partial_over=batch),
                      to_local(u, rows_ch), to_local(dt, rows_ch),
                      *(to_local(t, (batch, None, None), partial_over=(model,))
                        for t in (bmat, cmat)),
                      to_local(h0, (batch, model, None)))
    return (from_local(ys, rows_ch, u.shape),
            from_local(h, (batch, model, None), h0.shape))


def mamba_forward(params: dict, x: torch.Tensor, return_state: bool = False,
                  state: MambaState | None = None, n_valid: int | None = None):
    """x: [B, S, d_model] -> [B, S, d_model] (the prefill path), and with
    ``return_state`` the :class:`MambaState` after the last position.

    ``state``: continue from an earlier chunk's state (its conv tail stands
    in for the causal zero padding, the scan starts from its SSM state).
    ``n_valid``: positions >= n_valid are padding and exact state no-ops:
    dt = 0 makes the decay exp(0) = 1 and the input term 0, and the conv
    tail returned is the K - 1 inputs before position ``n_valid``."""
    b, s, _ = x.shape
    dt_x = x.dtype
    d_inner = params["out_proj"].shape[0]
    k = params["conv_w"].shape[0]
    xz = matmul_rows(x, params["in_proj"].to(dt_x))
    xi, z = xz.split(d_inner, dim=-1)                            # [B, S, d_inner]
    if state is not None and k > 1:
        tail = state.conv.to(dt_x)
    else:   # F.pad's zeros, by hand: torch 2.11's DTensor rule for pad is broken
        tail = torch.zeros((b, k - 1, d_inner), dtype=dt_x, device=x.device)
    xi_pad = torch.cat([tail, xi], dim=1)
    # in x's dtype, tap by tap from 0, as the reference's Python sum
    conv = sum(xi_pad[:, i:i + s, :] * params["conv_w"][i].to(dt_x) for i in range(k))
    u = silu(conv)
    dbc = matmul_rows(u, params["x_proj"].to(dt_x))              # [B, S, 1 + 2N]
    n = (dbc.shape[-1] - 1) // 2
    dt = _dt(params, dbc)
    if n_valid is not None:
        dt = dt * (torch.arange(s, device=x.device) < n_valid)[None, :, None]
    h0 = (torch.zeros((b, d_inner, n), dtype=torch.float32, device=x.device)
          if state is None else state.ssm.float())
    scan = _ssm_scan_sharded if is_dtensor(u) and get_context().active else _ssm_scan
    ys, h_fin = scan(-torch.exp(params["a_log"].float()), u.float(), dt,
                     dbc[..., 1:1 + n].float(), dbc[..., 1 + n:].float(), h0)
    y = ys.to(dt_x) + u * params["d_skip"].to(dt_x)
    y = y * silu(z)
    out = matmul_rows(y, params["out_proj"].to(dt_x))
    if not return_state:
        return out
    if k <= 1:
        tail = xi[:, :0, :]
    else:
        start = xi_pad.shape[1] - (k - 1) if n_valid is None else n_valid
        tail = xi_pad[:, start:start + k - 1, :]
    return out, MambaState(conv=tail.float(), ssm=h_fin)


def mamba_init_state(params: dict, batch: int) -> MambaState:
    d_inner = params["out_proj"].shape[0]
    k = params["conv_w"].shape[0]
    n = (params["x_proj"].shape[1] - 1) // 2
    dev = params["out_proj"].device
    return MambaState(conv=torch.zeros((batch, k - 1, d_inner), dtype=torch.float32, device=dev),
                      ssm=torch.zeros((batch, d_inner, n), dtype=torch.float32, device=dev))


def mamba_decode_step(params: dict, x_t: torch.Tensor, state: MambaState,
                      active: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, MambaState]:
    """x_t: [B, d_model], one token -> ([B, d_model], new state).

    ``active``: optional [B] bool, the ragged batch: inactive rows carry
    their (conv, ssm) state through unchanged. A recurrent state has no
    parking row (the row is the state), so the mask sits at the update."""
    dt_x = x_t.dtype
    d_inner = params["out_proj"].shape[0]
    xz = x_t @ params["in_proj"].to(dt_x)
    xi, z = xz.split(d_inner, dim=-1)                            # [B, d_inner]
    window = torch.cat([state.conv, xi[:, None, :].float()], dim=1)   # [B, K, d_inner] f32
    conv_w = params["conv_w"].float()
    conv = sum(window[:, i] * conv_w[i] for i in range(window.shape[1]))
    u = silu(conv).to(dt_x)
    dbc = u @ params["x_proj"].to(dt_x)
    n = (dbc.shape[-1] - 1) // 2
    dt = _dt(params, dbc)                                        # [B, d_inner]
    a = -torch.exp(params["a_log"].float())
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * u.float())[..., None] * dbc[..., None, 1:1 + n].float()
    h = da * state.ssm + dbx
    y = torch.einsum("bdn,bn->bd", h, dbc[..., 1 + n:].float())
    y = y.to(dt_x) + u * params["d_skip"].to(dt_x)
    y = y * silu(z)
    conv_new, ssm_new = window[:, 1:], h
    if active is not None:
        m3 = active[:, None, None]
        conv_new = torch.where(m3, conv_new, state.conv)
        ssm_new = torch.where(m3, ssm_new, state.ssm)
    return y @ params["out_proj"].to(dt_x), MambaState(conv=conv_new, ssm=ssm_new)
