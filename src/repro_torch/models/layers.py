"""Shared layer primitives: norms, MLPs, the (dense or W4A8) projection, and
parameter init. Port of ``repro.models.layers``.

Parameters are nested dicts of tensors; stacked layer tensors keep a
leading ``[L, ...]`` axis. Weights are ``[K, N]`` and used as ``x @ W``.
"""
from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F

from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(dt)


def dense_init(gen: torch.Generator, shape: tuple[int, ...], *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/d_in) weights of ``shape = (..., d_in, d_out)``, drawn one
    ``[d_in, d_out]`` matrix at a time in float32 and stored in ``dtype``
    (so a stacked full-width weight never exists twice in float32)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    scale = (1.0 / shape[-2]) ** 0.5
    for idx in itertools.product(*(range(s) for s in shape[:-2])):
        out[idx] = torch.randn(shape[-2:], generator=gen, device=gen.device) * scale
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Projection through params dict ``p``: dense ``p[name]`` or the W4A8
    pair ``p[name+'__qp']`` (int4-packed) / ``p[name+'__qs']`` (group
    scales) made by ``models.quantized.quantize_params``. The W4A8 form
    chooses by device, as the reference chooses by backend: the GEMV
    kernel's wrapper launches the CUDA kernel for CUDA tensors and runs its
    plain version (``w4a8_matmul_ref``) for CPU tensors."""
    qp = p.get(name + "__qp")
    if qp is None:
        return x @ p[name].to(x.dtype)
    return gemv_ops.gemv_w4a8(x, qp, p[name + "__qs"]).to(x.dtype)


def mlp_init(gen: torch.Generator, lead: tuple[int, ...], d_model: int,
             d_ff: int, gated: bool, *,
             dtype: torch.dtype = torch.float32) -> dict:
    p = {"up": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
         "down": dense_init(gen, (*lead, d_ff, d_model), dtype=dtype)}
    if gated:
        p["gate"] = dense_init(gen, (*lead, d_model, d_ff), dtype=dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    up = linear(p, "up", x)
    if gated:
        up = act_fn(act)(linear(p, "gate", x)) * up
    else:
        up = act_fn(act)(up)
    return linear(p, "down", up)
