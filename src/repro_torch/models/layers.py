"""Shared layer primitives: norms, MLPs, the (dense or W4A8) projection, and
parameter init. Port of ``repro.models.layers``.

Parameters are nested dicts of tensors; stacked layer tensors keep a
leading ``[L, ...]`` axis. Weights are ``[K, N]`` and used as ``x @ W``.

The sharding constraints (:func:`maybe_constrain`,
:func:`batch_vocab_constrain`) redistribute a ``DTensor`` under an active
``distributed.context`` and leave every other tensor as it is.
"""
from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import get_context
from repro_torch.distributed.sharding import batch_model_spec, constrain, matmul_rows
from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops


def maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Sharding constraint against the active distribution context: ``axes``
    (mesh-axis names, tuples of them or None, one per dim) as the placements
    of a ``DTensor``; a no-op outside a context and on a plain tensor."""
    return constrain(x, axes)


def batch_vocab_constrain(x: torch.Tensor) -> torch.Tensor:
    """Pin a [..., V] activation (the logits) to (batch over the batch axes,
    vocab over the model axis), each where it divides the dim. Under FSDP
    the unembed product leaves V unsharded (the data axis is claimed by
    both the batch and the contraction), a [B, S, V] float32 per process at
    full vocab."""
    if not get_context().active:
        return x
    return maybe_constrain(x, *batch_model_spec(x, x.dim() - 1))


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


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: forward as XLA's CPU lowers it, backward by its
    derivative rule, ``g * (ans * (1 - ans))``, each op rounding to the
    dtype. Autograd through the written-out forward (reciprocal, add, exp)
    would round differently: in bf16 it moved a third of SiLU's input
    cotangents by a bf16 step (``tools/bf16_grad_divergence.py --ops``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ans = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounding to x's dtype: how the
    reference's ``jax.nn.sigmoid`` (``lax.logistic``) lowers on XLA's CPU
    (``torch.sigmoid`` rounds once); its gradient is the reference's
    (:class:`_Logistic`)."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid written out as the reference's
    ``jax.nn.silu`` lowers it, ``1 / (1 + exp(-x))``, each op rounding to
    x's dtype. ``F.silu`` rounds once, so in bf16 it differs from the
    reference in about a third of its outputs by one bf16 step."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as the reference's ``jax.nn.softplus`` computes
    it: ``logaddexp(x, 0)``, which JAX writes out as ``max(x, 0) +
    log1p(exp(-|x - 0|))`` (``x + 0`` where ``x - 0`` is NaN), each op
    rounding to x's dtype. ``torch.logaddexp`` rounds once, and
    ``F.softplus`` turns into the identity above its threshold."""
    zero = torch.zeros_like(x)
    delta = x - zero
    return torch.where(torch.isnan(delta), x + zero,
                       torch.maximum(x, zero) + torch.log1p(torch.exp(-delta.abs())))


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d CPU tensor of ``value`` rounded to ``dtype``: an operand of a
    tensor op rounds to the tensor's dtype, as the reference's weak-typed
    constants do, where a Python scalar would stay in float32. Made outside
    inference mode: the cached tensor also enters products that autograd
    records (training), which an inference tensor may not."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU written out as the reference's ``jax.nn.gelu``
    lowers it: ``x * (0.5 * (1 + tanh(c2 * (x + c1 * ((x * x) * x)))))``
    (``x ** 3`` is XLA's ``integer_pow``, two multiplies), every op and
    both constants ``c1 = 0.044715`` and ``c2 = sqrt(2 / pi)`` rounding to
    x's dtype. ``F.gelu(approximate="tanh")`` rounds once, and in bf16
    differs from the reference in ~2% of all inputs."""
    dt = x.dtype
    inner = _const(_SQRT_2_OVER_PI, dt) * (x + _const(0.044715, dt) * ((x * x) * x))
    return x * (_const(0.5, dt) * (_const(1.0, dt) + torch.tanh(inner)))


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu}[name]


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Projection through params dict ``p``: dense ``p[name]``
    (:func:`~repro_torch.distributed.sharding.matmul_rows`) or the W4A8
    pair ``p[name+'__qp']`` (int4-packed) / ``p[name+'__qs']`` (group
    scales) made by ``models.quantized.quantize_params``. The W4A8 form
    chooses by device, as the reference chooses by backend: the GEMV
    kernel's wrapper launches the CUDA kernel for CUDA tensors and runs its
    plain version (``w4a8_matmul_ref``) for CPU tensors."""
    qp = p.get(name + "__qp")
    if qp is None:
        return matmul_rows(x, p[name].to(x.dtype))
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
