"""The port's paper-literal numerics against the reference, at reduced size,
on inputs made from a numpy seed.

* LUT exponential (paper Eqs. 9-10): the kernel form ``ref.exp_lut_kernel``
  bit for bit the reference kernel's jitted ``_exp_lut`` on 400,001 points
  of [-200, 0] plus the edges (the subnormal flush below x ~ -87.34 and the
  n clamp that makes exp(-1e30) 2^-126); the float path ``exp_lut`` /
  ``exp2_frac_lut`` bit for bit the reference's under ``jax.jit`` (XLA
  contracts the interpolation into one fused multiply-add there);
  ``max_relative_error`` within 5% of the paper's 5.86e-5.
* Q15.17 (paper §III): ``exp_lut_fxp``, the fixed-point primitives and
  ``swiftkv_attention_fxp`` (d 128, S 512) bit for bit the reference's.
* The LUT form of the decode kernel: its plain version (what the wrapper
  runs on CPU tensors: the cache folded as one block with the LUT) against
  the reference's Pallas kernel with ``exp_mode="lut"`` in interpret mode.
  Tolerance 3e-5: where a row spans two of the Pallas kernel's 128-row
  blocks, it rescales by exp(a) exp(b) where the plain version takes
  exp(a + b), and the two differ by up to the LUT's error (measured worst
  1.5e-5 over six seeds; 2e-7 for rows inside one block).
* The tokenwise path: ``swiftkv_decode_tokenwise`` (branchy and fused)
  against the reference's, vmapped as its ``decode_attention`` does,
  within 2e-6 (float32; the dot products sum in another order); reduced
  llama2-7b float32 with ``decode_impl="tokenwise"``: lock-step logits
  within 1e-4 of the reference's (as ``tests/test_torch_serving.py``) and
  greedy tokens equal; the continuous engine's greedy tokens equal the
  reference engine's on the conformance trace; the reference's fallbacks:
  ``+w4a8`` and ``+ring`` bit for bit the port's blockwise path, a linear
  window raises on both sides.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import exp2_lut as jax_lut
from repro.core import fixedpoint as jax_fxp
from repro.core import swiftkv as jax_swiftkv
from repro.kernels.swiftkv_decode import ops as jax_ops
from repro.kernels.swiftkv_decode.kernel import _exp_lut
from repro.models.api import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import exp2_lut, fixedpoint, swiftkv
from repro_torch.kernels.swiftkv_decode import ops
from repro_torch.kernels.swiftkv_decode import ref as kref
from repro_torch.models.api import build_model
from repro_torch.models.quantized import quantize_params
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace

PAPER_LUT_ERR = 5.86e-5
EDGES = np.float32([-1e30, 0.0, -0.0, -87.3365, -87.34, -87.35, -126 * 0.6931472, -1e-40])
GRID = np.concatenate([np.linspace(-200, 0, 400_001, dtype=np.float32), EDGES])
LUT_ATOL = 3e-5
TOKENWISE_ATOL = 2e-6
LOGIT_ATOL = 1e-4


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ---------------------------------------------------------------------------
# LUT exponential
# ---------------------------------------------------------------------------

def test_exp_lut_kernel_bitwise_equals_the_reference_kernel_form():
    lut = [jnp.asarray(t, jnp.float32) for t in jax_lut.make_lut()]
    want = jax.jit(_exp_lut)(jnp.asarray(GRID), *lut)
    got = kref.exp_lut_kernel(torch.from_numpy(GRID))
    assert (_bits(got) != _bits(want)).sum() == 0
    # the traps: ~14k grid points below -87.34 flush to 0, and the clamp
    # of n to -126 leaves exp(-1e30) at 2^-126
    assert (got[:400_001] == 0).sum() > 13_000
    assert got[400_001].item() == 2.0 ** -126


@pytest.mark.parametrize("fn", ["exp_lut", "exp2_frac_lut"])
def test_float_path_bitwise_equals_the_jitted_reference(fn):
    x = GRID if fn == "exp_lut" else -np.linspace(0, 1, 400_001, endpoint=False,
                                                  dtype=np.float32)
    want = jax.jit(getattr(jax_lut, fn))(jnp.asarray(x))
    got = getattr(exp2_lut, fn)(torch.from_numpy(x))
    assert (_bits(got) != _bits(want)).sum() == 0


def test_lut_tables_and_error_bound():
    for got, want in zip(exp2_lut.make_lut(), jax_lut.make_lut()):
        np.testing.assert_array_equal(got, want)
    err = exp2_lut.max_relative_error()
    assert abs(err - PAPER_LUT_ERR) <= 0.05 * PAPER_LUT_ERR, err


# ---------------------------------------------------------------------------
# Q15.17 fixed point
# ---------------------------------------------------------------------------

def test_exp_lut_fxp_bitwise():
    x = np.concatenate([np.linspace(-40, 0, 200_001), -np.arange(0, 50)])
    x_fxp = jax_fxp.to_fxp(x)
    np.testing.assert_array_equal(exp2_lut.exp_lut_fxp(x_fxp), jax_lut.exp_lut_fxp(x_fxp))


@pytest.mark.parametrize("fn", ["to_fxp", "from_fxp", "fxp_mul", "fxp_div", "fxp_dot"])
def test_fxp_primitives_bitwise(fn):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 32)) * 100
    b = rng.standard_normal((64, 32)) * 10
    b[0, :4] = 0                                 # the divider's zero case
    if fn == "to_fxp":
        args = (a,)
    elif fn == "from_fxp":
        args = (jax_fxp.to_fxp(a),)
    else:
        args = (jax_fxp.to_fxp(a), jax_fxp.to_fxp(b))
    np.testing.assert_array_equal(getattr(fixedpoint, fn)(*args), getattr(jax_fxp, fn)(*args))


def test_attention_fxp_bitwise():
    rng = np.random.default_rng(4)
    d, s = 128, 512
    q, k, v = rng.standard_normal(d), rng.standard_normal((s, d)), rng.standard_normal((s, d))
    np.testing.assert_array_equal(fixedpoint.swiftkv_attention_fxp(q, k, v),
                                  jax_fxp.swiftkv_attention_fxp(q, k, v))


# ---------------------------------------------------------------------------
# the LUT form of the decode kernel
# ---------------------------------------------------------------------------

def test_lut_decode_vs_reference_kernel_interpret():
    """``mk(2, 4, 2, 256, 64)`` as the reference's ``test_kernel_lut_exp_mode``;
    also within the reference's 5e-4 of the softmax oracle, and not the
    native form."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 64)).astype(np.float32)
    lengths = np.asarray([232, 190], np.int32)           # two Pallas blocks each
    want = np.asarray(jax_ops.swiftkv_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), block_k=128,
        exp_mode="lut", interpret=True))
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got = ops.swiftkv_decode(*args, exp_mode="lut").numpy()
    native = ops.swiftkv_decode(*args).numpy()
    np.testing.assert_allclose(got, want, atol=LUT_ATOL)
    np.testing.assert_allclose(got, native, atol=5e-4)
    assert not np.array_equal(got, native)


# ---------------------------------------------------------------------------
# the tokenwise path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branchy", [True, False], ids=["branchy", "fused"])
def test_tokenwise_vs_reference(branchy):
    rng = np.random.default_rng(5)
    b, hkv, g, s, d = 3, 2, 4, 48, 32
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = np.asarray([0, 17, s], np.int32)
    fn = functools.partial(jax_swiftkv.swiftkv_decode_tokenwise, branchy=branchy)
    per_group = jax.vmap(fn, in_axes=(0, None, None, None))     # the reference's nest
    per_head = jax.vmap(per_group, in_axes=(0, 0, 0, None))
    per_batch = jax.vmap(per_head, in_axes=(0, 0, 0, 0))
    want = np.asarray(per_batch(jnp.asarray(q), jnp.swapaxes(jnp.asarray(k), 1, 2),
                                jnp.swapaxes(jnp.asarray(v), 1, 2), jnp.asarray(lengths)))
    got = swiftkv.swiftkv_decode_tokenwise(*(torch.from_numpy(x) for x in (q, k, v, lengths)),
                                           branchy=branchy).numpy()
    np.testing.assert_allclose(got, want, atol=TOKENWISE_ATOL)
    assert (got[0] == 0).all() and (want[0] == 0).all()
    blockwise = swiftkv.swiftkv_decode_blockwise(
        *(torch.from_numpy(x) for x in (q, k, v, lengths)), block_size=16).numpy()
    np.testing.assert_allclose(got, blockwise, atol=TOKENWISE_ATOL)


def _pair(name: str, decode_impl: str):
    jcfg = jax_get_config(name, reduced=True).replace(decode_impl=decode_impl)
    tcfg = get_config(name, reduced=True).replace(decode_impl=decode_impl)
    jm = jax_build_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, params, tm, from_jax(jax.tree.map(np.asarray, params), "cpu")


def test_tokenwise_lockstep_matches_reference():
    """Reduced llama2-7b, float32: prefill and two decode steps' logits,
    and ``generate``'s greedy tokens (batch 3, prompt 12, 10 steps)."""
    jm, params, tm, tparams = _pair("llama2-7b", "tokenwise")
    batch, max_len = 3, 64
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (batch, 12))
    prompts = prompts.astype(np.int32)
    want = np.asarray(JaxServingEngine(jm, params, max_len=max_len, batch=batch)
                      .generate(jnp.asarray(prompts), steps=10))
    got = ServingEngine(tm, tparams, max_len=max_len, batch=batch).generate(
        torch.from_numpy(prompts), steps=10).numpy()
    np.testing.assert_array_equal(got, want)
    jcache, tcache = jm.init_cache(batch, max_len), tm.init_cache(batch, max_len)
    jl, jcache = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jcache)
    with torch.inference_mode():
        tl, tcache = tm.prefill(tparams, torch.from_numpy(prompts), tcache)
        decode = jax.jit(jm.decode_step)
        for _ in range(2):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jcache = decode(params, tok, jcache)
            tl, tcache = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)


def test_tokenwise_continuous_matches_reference_engine():
    """The conformance trace (4 requests, 2 slots, max_len 64, chunk 8)."""
    jm, params, tm, tparams = _pair("llama2-7b", "tokenwise")
    kw = {"n_requests": 4, "vocab_size": jm.cfg.vocab_size, "prompt_len": (3, 18),
          "max_new": (3, 12), "seed": 5}
    setup = {"n_slots": 2, "max_len": 64, "chunk": 8}
    want = JaxEngine(jm, params, **setup).run(jax_poisson_trace(**kw))
    got = ContinuousBatchingEngine(tm, tparams, **setup).run(poisson_trace(**kw))
    tokens = lambda report: {r["rid"]: r["tokens"] for r in report["requests"]}
    assert tokens(got) == tokens(want)
    assert got["aggregate"]["n_retired"] == 4


@pytest.mark.parametrize("name,prompt_len,max_len", [("llama2-7b+w4a8", 12, 64),
                                                     ("h2o-danube-1.8b+ring", 150, 256)])
def test_tokenwise_falls_back_to_blockwise(name, prompt_len, max_len):
    """An int8 cache and a ring cache have no per-token form: the
    reference's ``decode_attention`` takes blockwise for them, and so does
    the port's, bit for bit (the ring: a prompt longer than its 128
    slots)."""
    cfg = get_config(name, reduced=True)
    params = build_model(cfg, device="cpu").init_params(0)
    if cfg.w4a8_serve:
        params = quantize_params(params)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32))
    outs = []
    for impl in ("tokenwise", "blockwise"):
        model = build_model(cfg.replace(decode_impl=impl), device="cpu")
        with torch.inference_mode():
            logits, cache = model.prefill(params, prompts, model.init_cache(2, max_len))
            steps = [logits]
            for _ in range(3):
                logits, cache = model.decode_step(params, logits.argmax(-1).to(torch.int32),
                                                  cache)
                steps.append(logits)
        outs.append(torch.stack(steps))
    assert torch.equal(outs[0], outs[1])


def test_tokenwise_linear_window_raises_as_the_reference():
    jm, params, tm, tparams = _pair("h2o-danube-1.8b", "tokenwise")
    prompts = np.zeros((1, 8), np.int32)
    jl, jcache = jm.prefill(params, jnp.asarray(prompts), jm.init_cache(1, 64))
    with pytest.raises(NotImplementedError, match="tokenwise path: use blockwise for SWA"):
        jm.decode_step(params, jnp.argmax(jl, -1).astype(jnp.int32), jcache)
    tl, tcache = tm.prefill(tparams, torch.from_numpy(prompts), tm.init_cache(1, 64))
    with pytest.raises(NotImplementedError, match="tokenwise path: use blockwise for SWA"):
        tm.decode_step(tparams, tl.argmax(-1).to(torch.int32), tcache)
