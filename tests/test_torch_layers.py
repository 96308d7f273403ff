"""The port's RoPE, norms, MLP, projections and prefill attention against the
reference on the same numpy inputs.

Tolerance: 1e-5 absolute on O(1) float32 values unless stated — both sides
compute in float32; transcendental functions (cos/sin, exp, rsqrt) and sums
may differ in their last bits between XLA and PyTorch."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import quantization as jq
from repro.core import rope as jrope
from repro.models import layers as jlayers
from repro_torch.core import attention as tattn
from repro_torch.core import rope as trope
from repro_torch.kernels.gemv_w4a8 import ref as gemv_ref
from repro_torch.models import layers as tlayers

RNG = np.random.default_rng(9)
ATOL = 1e-5


def f32(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("base,rotary_dim", [(10000.0, None), (1e6, None), (10000.0, 8)])
def test_apply_rope_direct(base, rotary_dim):
    x = f32(2, 3, 40, 16)
    pos = np.arange(40) + 7
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base, rotary_dim)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), base, rotary_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rope_incremental_matches_reference_and_direct():
    """The Eq. 11 recurrence, advanced 300 steps from position 5, tracks the
    reference's recurrence (same operation order, so the same drift) and
    rotates a vector as the direct form does at the reached position.

    Tolerance: each side rounds every step in its last bit on its own (XLA
    may contract into FMAs), and a rotation's rounding error grows about
    linearly: ~2 x 300 steps x 2^-24 ~ 4e-5."""
    dh, base, p0, steps = 16, 10000.0, 5, 300
    atol = 5e-5
    ts = trope.rope_state_init(dh, base, p0)
    js = jrope.rope_state_init(dh, base, p0)
    for _ in range(steps):
        ts, js = trope.rope_state_advance(ts), jrope.rope_state_advance(js)
    np.testing.assert_allclose(ts.cos_m.numpy(), np.asarray(js.cos_m), atol=atol)
    np.testing.assert_allclose(ts.sin_m.numpy(), np.asarray(js.sin_m), atol=atol)
    x = f32(4, dh)
    got = trope.apply_rope_from_state(torch.from_numpy(x), ts).numpy()
    np.testing.assert_allclose(got, np.asarray(jrope.apply_rope_from_state(jnp.asarray(x), js)),
                               atol=atol)
    direct = trope.apply_rope(torch.from_numpy(x)[:, None], torch.tensor([p0 + steps]), base)
    np.testing.assert_allclose(got, direct[:, 0].numpy(), atol=1e-4)   # Eq. 11 drift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, w = f32(3, 5, 64, scale=3.0), f32(64) + 1.0
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tlayers.rms_norm(xt, torch.from_numpy(w)).float().numpy()
    want = np.asarray(jlayers.rms_norm(xj, jnp.asarray(w)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=ATOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True), ("gelu", False),
                                       ("relu", False)])
def test_mlp_apply(act, gated):
    p = {"up": f32(64, 96, scale=0.125), "down": f32(96, 64, scale=0.1)}
    if gated:
        p["gate"] = f32(64, 96, scale=0.125)
    x = f32(2, 7, 64)
    got = tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), act, gated)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             act, gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("route", ["linear", "plain"])
def test_linear_dense_and_quantized(route):
    """Dense ``x @ W`` and the W4A8 pair made by the reference's quantizer
    agree with the reference, through ``linear`` (which on CPU tensors runs
    the GEMV kernel's plain version) and through that plain version
    (``gemv_w4a8/ref.py``) called directly."""
    x, w = f32(3, 4, 256), f32(256, 96, scale=0.06)
    qw = jq.quantize_w4(jnp.asarray(w))
    jp = {"wq": jnp.asarray(w), "wk__qp": qw.packed, "wk__qs": qw.scale}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    xt = torch.from_numpy(x)
    for name in ("wq", "wk"):
        if route == "plain" and name == "wk":
            got = gemv_ref.gemv_w4a8_ref(xt, tp["wk__qp"], tp["wk__qs"])
        else:
            got = tlayers.linear(tp, name, xt)
        want = jlayers.linear(jp, name, jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=name)


PREFILL_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, kv_lengths, kv_block
    (2, 24, 24, 4, 4, 16, True, None, None, 8),        # MHA, 3 KV blocks
    (2, 24, 24, 4, 2, 16, True, None, None, 512),      # GQA, one block
    (2, 33, 33, 4, 2, 16, True, 10, None, 16),         # sliding window
    (3, 9, 40, 4, 1, 32, False, None, [40, 17, 1], 16),  # cross-style, ragged KV
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,kv_lengths,kv_block",
                         PREFILL_CASES)
def test_prefill_attention(b, sq, skv, hq, hkv, d, causal, window, kv_lengths, kv_block):
    q, k, v = f32(b, sq, hq, d), f32(b, skv, hkv, d), f32(b, skv, hkv, d)
    kw = dict(causal=causal, window=window, kv_block=kv_block)
    lens = None if kv_lengths is None else np.asarray(kv_lengths, np.int32)
    got = tattn.prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_lengths=None if lens is None else torch.from_numpy(lens), **kw)
    want = jattn.prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        kv_lengths=None if lens is None else jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_attention_q_offset():
    """Appended queries at absolute positions ``q_offset`` (causal mask
    against earlier keys)."""
    q, k, v = f32(2, 5, 4, 16), f32(2, 20, 2, 16), f32(2, 20, 2, 16)
    off = np.asarray([15, 3], np.int32)
    got = tattn.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  q_offset=torch.from_numpy(off), kv_block=8)
    want = jattn.prefill_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   q_offset=jnp.asarray(off), kv_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
