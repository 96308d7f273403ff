#!/usr/bin/env python3
"""Where the port and the JAX reference round bf16 differently (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_rounding_points.py
    PYTHONPATH=src JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_allow_excess_precision=false \
        python tools/bf16_rounding_points.py

Compares, on the same bf16 inputs, single ops and small fused chains of the
reference (each under ``jax.jit``) with the port's eager ops, counting the
outputs that differ: SiLU as ``F.silu`` (one rounding) and as the port's
``layers.silu`` (the reference's ops, each rounding), ``rms_norm(x + y)``
and ``quantize_a8(silu(g) * u)``. Then the reduced ``llama2-7b+w4a8`` bf16
serving case of ``tests/test_torch_serving.py`` (PRNGKey(0) weights
quantized by the reference, batch 3 x 12 prompts from
``default_rng(1)``): greedy tokens of both sides over 10 steps and the max
|logit difference| per step, teacher-forced on the reference's tokens.

Run it twice, with and without ``--xla_allow_excess_precision=false``: the
chains differ only while XLA may skip roundings inside its fusions, and
the serving case then matches bit for bit. Compares two packages, so it
imports both; the port itself imports no JAX.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.core import quantization as jq
from repro.models import layers as jl
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantize_params as jax_quantize_params
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import quantization as tq
from repro_torch.models import layers as tl
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine


def _pair(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _differ(j, t) -> str:
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy()
    return f"{int((j != t).sum())} of {j.size} differ (max {np.abs(j - t).max():.4g})"


def ops() -> None:
    rng = np.random.default_rng(0)
    x_j, x_t = _pair(rng, 64, 64)
    y_j, y_t = _pair(rng, 64, 64)
    g_j, g_t = _pair(rng, 64, 96)
    w_j, w_t = jnp.ones(64, jnp.float32), torch.ones(64)
    silu_j = jax.jit(jax.nn.silu)(g_j)
    print(f"silu, F.silu: {_differ(silu_j, F.silu(g_t))}")
    print(f"silu, port layers.silu: {_differ(silu_j, tl.silu(g_t))}")
    print("rms_norm(x + y): "
          + _differ(jax.jit(lambda a, b: jl.rms_norm(a + b, w_j))(x_j, y_j),
                    tl.rms_norm(x_t + y_t, w_t)))
    print("quantize_a8(silu(g) * u) codes: "
          + _differ(jax.jit(lambda a, b: jq.quantize_a8(jax.nn.silu(a) * b)[0])(x_j, y_j),
                    tq.quantize_a8(tl.silu(x_t) * y_t)[0]))


def serving() -> None:
    name, over = "llama2-7b+w4a8", {"decode_impl": "kernel", "compute_dtype": "bfloat16"}
    jm = jax_build_model(jax_get_config(name, reduced=True).replace(**over))
    tm = build_model(get_config(name, reduced=True).replace(**over), device="cpu")
    params = jax_quantize_params(jm.init_params(jax.random.PRNGKey(0)))
    tparams = from_jax(jax.tree.map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (3, 12)).astype(np.int32)
    port = ServingEngine(tm, tparams, max_len=64, batch=3).generate(
        torch.from_numpy(prompts), steps=10).numpy()
    jc, tc = jm.init_cache(3, 64), tm.init_cache(3, 64)
    jlog, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jc)
    with torch.inference_mode():
        tlog, tc = tm.prefill(tparams, torch.from_numpy(prompts), tc)
    decode = jax.jit(jm.decode_step)
    diffs, ref = [], []
    for _ in range(11):
        diffs.append(float(np.abs(np.asarray(jlog, np.float32) - tlog.numpy()).max()))
        if len(ref) == 10:
            break
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        ref.append(tok)
        jlog, jc = decode(params, jnp.asarray(tok), jc)
        with torch.inference_mode():
            tlog, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc)
    ref = np.stack(ref, axis=1)
    print(f"serving {name} bf16: tokens equal {(ref == port).all()}; "
          f"reference {ref.tolist()}; port {port.tolist()}")
    print("max |logit diff| by step (prefill, 10 decode steps): "
          + ", ".join(f"{d:.4g}" for d in diffs))


if __name__ == "__main__":
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    ops()
    serving()
