"""The port's ring-KV sliding-window path against the reference, at reduced
size, on the same numpy inputs and the same converted weights.

* Kernel function: ``ops.swiftkv_decode(ring=True)`` (its plain version on
  CPU tensors) and the port's blockwise and naive ring paths against the
  reference's Pallas kernel with ``ring=True`` in interpret mode and its
  dense oracle ``decode_attention_ring``: float32 within 2e-5 (both sides
  compute in f32, in other summation orders; the reference's own kernel
  tests use that bound); a row of length 0 is exactly 0.
* Split model: ``swiftkv_decode_split_ref(ring=True)`` at n_split 1, 2, 3
  and 8 within 1e-6 of the dense oracle, and bit for bit the linear split
  model on the unrolled cache (the kernel's ring and linear forms fold the
  same chunks in the same order).
* Core functions: the ring forms of blockwise decode, the dense oracle and
  ``prefill_attention_ring`` within 2e-5, stale and in-chunk-overwritten
  slots included.
* Model: reduced ``h2o-danube-1.8b``, ``+ring`` and ``+ring+w4a8`` (window
  32; max_len 256, so a ring of 128) at prompts below the window, between
  window and ring, and longer than the ring (prefill wraps): prefill and 16
  greedy steps, logits within 1e-4 (float32 end to end over 17 forwards;
  the reference's ring tests use that bound), caches within 1e-5 (int8
  codes and bf16 scales exactly), tokens equal; ring against its linear
  twin in the port.
* Continuous: the port's engine against the reference engine on a trace
  whose prompts exceed the ring (greedy tokens equal), ring sizing and its
  bound check, release zeroing, the O(window) memory line, and a mid-block
  EOS on the wrap boundary.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import attention as jax_attn
from repro.core.quantization import quantize_kv as jax_quantize_kv
from repro.kernels.swiftkv_decode import ops as jax_ops
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import attention as attn
from repro_torch.kernels.swiftkv_decode import ops
from repro_torch.kernels.swiftkv_decode import ref as kref
from repro_torch.models.api import build_model
from repro_torch.serving import (ContinuousBatchingEngine, Request, ServingEngine,
                                 poisson_trace)

ATOL = 2e-5
R = 128                      # ring slots of the kernel cases
LENS = [0, 1, 31, 33, 127, 128, 129, 389]
MAX_LEN = 256                # the reference's ring tests: a ring of 128
BASE, RING, RING_Q = "h2o-danube-1.8b", "h2o-danube-1.8b+ring", "h2o-danube-1.8b+ring+w4a8"


def _inputs(g: int, int8: bool, seed: int = 7, d: int = 32, hkv: int = 2):
    """q [B, G*Hkv, D], ring caches [B, R, Hkv, D] (int8 with the
    reference's bf16 scales [B, Hkv, R], plus their dequantized f32),
    lengths LENS: numpy."""
    rng = np.random.default_rng(seed)
    b = len(LENS)
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    k = rng.standard_normal((b, R, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, R, hkv, d)).astype(np.float32)
    kw, kf, vf = {}, k, v
    if int8:
        def quant(x):
            q8, s = jax_quantize_kv(jnp.asarray(x))
            return np.asarray(q8), np.asarray(jnp.swapaxes(s, 1, 2).astype(jnp.bfloat16))
        (k, ks), (v, vs) = quant(k), quant(v)
        kw = {"k_scale": ks, "v_scale": vs}
        deq = lambda x8, sc: x8.astype(np.float32) * np.swapaxes(
            sc.astype(np.float32), 1, 2)[..., None]
        kf, vf = deq(k, ks), deq(v, vs)
    return q, k, v, np.asarray(LENS, np.int32), kw, kf, vf


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the kernel function and its plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [32, 100])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ring_decode_vs_reference_kernel_and_oracle(int8, window, g):
    q, k, v, lengths, kw, kf, vf = _inputs(g, int8)
    jkw = {n: jnp.asarray(x) for n, x in kw.items()}
    want = np.asarray(jax_ops.swiftkv_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        window=window, ring=True, block_k=R, interpret=True, **jkw))
    oracle = np.asarray(jax_attn.decode_attention_ring(
        jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(lengths),
        window=window))
    np.testing.assert_allclose(want, oracle, atol=ATOL)
    args = [_t(x) for x in (q, k, v, lengths)]
    tkw = {n: _t(x) for n, x in kw.items()}
    got = {"ops": ops.swiftkv_decode(*args, window=window, ring=True, **tkw)}
    for impl in ("kernel", "blockwise", "naive"):
        got[impl] = attn.decode_attention(*args, impl=impl, window=window, ring=True,
                                          block_size=64, **tkw)
    for name, out in got.items():
        np.testing.assert_allclose(out.numpy(), want, atol=ATOL, err_msg=name)
        assert (out[0] == 0).all(), f"{name}: a row of length 0 is exactly 0"


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ring_split_model(int8, n_split):
    """The plain model of the kernel's split, ring form: within 1e-6 of the
    dense oracle, and bitwise the linear split model on the unrolled cache."""
    q, k, v, lengths, kw, _, _ = _inputs(4, int8, seed=9)
    window = 100
    tq, tk, tv, tl = (_t(x) for x in (q, k, v, lengths))
    tkw = {n: _t(x) for n, x in kw.items()}
    dense = kref.swiftkv_decode_ref(tq, tk, tv, tl, window=window, ring=True, **tkw)
    got = kref.swiftkv_decode_split_ref(tq, tk, tv, tl, n_split=n_split, window=window,
                                        ring=True, **tkw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6)
    unrolled = {n: kref.unroll_ring(x, tl, 2) for n, x in tkw.items()}
    linear = kref.swiftkv_decode_split_ref(
        tq, kref.unroll_ring(tk, tl, 1), kref.unroll_ring(tv, tl, 1), tl,
        n_split=n_split, window=window, **unrolled)
    assert torch.equal(got, linear)


@pytest.mark.parametrize("window", [1, 50, R - 1, 4 * R])
def test_ring_chunk_bounds_cover_the_window_in_position_space(window):
    """Ring chunks cut [len - min(window, R), len) of unclamped lengths into
    tile-aligned runs in split order; the positions of a row fall in
    distinct slots (t mod R)."""
    lengths = torch.tensor(LENS + [3 * R + 5])
    for n_split in (1, 2, 3, 8):
        bounds = kref.chunk_bounds(lengths, R, n_split=n_split, window=window, ring=True)
        for row, length in enumerate(lengths.tolist()):
            lo = max(0, length - min(window, R))
            spans = [(int(s[row]), int(e[row])) for s, e in bounds if e[row] > s[row]]
            covered = [t for s, e in spans for t in range(s, e)]
            assert covered == list(range(lo, length))
            assert len({t % R for t in covered}) == len(covered)
            assert all(s % kref.TILE == 0 for s, _ in spans[1:])


def test_argument_checks():
    """A ring needs a window; the ring form with ``exp_mode="lut"`` runs and
    is held to the reference's Pallas LUT kernel with ``ring=True`` in
    interpret mode, int8 ring included (within 2e-6: one block of R rows,
    the same exponentials on both sides; measured worst 3.3e-7), a row of
    length 0 exactly 0."""
    q, k, v, lengths, _, _, _ = _inputs(1, False)
    args = [_t(x) for x in (q, k, v, lengths)]
    with pytest.raises(ValueError, match="window"):
        ops.swiftkv_decode(*args, ring=True)
    with pytest.raises(ValueError, match="window"):
        attn.decode_attention(*args, impl="blockwise", ring=True)
    for int8 in (False, True):
        q, k, v, lengths, kw, _, _ = _inputs(2, int8)
        want = np.asarray(jax_ops.swiftkv_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), window=32,
            ring=True, block_k=R, exp_mode="lut", interpret=True,
            **{n: jnp.asarray(x) for n, x in kw.items()}))
        got = ops.swiftkv_decode(*(_t(x) for x in (q, k, v, lengths)), ring=True, window=32,
                                 exp_mode="lut", **{n: _t(x) for n, x in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
        assert (got[0] == 0).all()


# ---------------------------------------------------------------------------
# core functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_blockwise_ring_vs_reference_blockwise(int8):
    q, k, v, lengths, kw, _, _ = _inputs(2, int8, seed=3)
    jkw = {n: jnp.asarray(x) for n, x in kw.items()}
    want = np.asarray(jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        impl="blockwise", window=40, ring=True, block_size=48, **jkw))
    got = attn.decode_attention(*[_t(x) for x in (q, k, v, lengths)], impl="blockwise",
                                window=40, ring=True, block_size=48,
                                **{n: _t(x) for n, x in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_decode_attention_ring_oracle_vs_reference():
    q, _, _, lengths, _, kf, vf = _inputs(2, True, seed=4)
    want = np.asarray(jax_attn.decode_attention_ring(
        jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(lengths), window=77))
    got = attn.decode_attention_ring(*[_t(x) for x in (q, kf, vf, lengths)], window=77)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("offset,last", [(0, 15), (40, 9), (120, 15), (250, 5)])
def test_prefill_attention_ring_vs_reference(offset, last):
    """A chunk of 16 queries at [offset, offset + 16) over a ring of 64 that
    holds stale slots (a previous occupant's values, negative positions
    until this request wraps) and, at offsets 120 and 250, slots the chunk
    itself overwrote; rows past ``last`` are padding."""
    rng = np.random.default_rng(offset)
    c, r, hkv, g, d = 16, 64, 2, 2, 16
    q = rng.standard_normal((1, c, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((1, r, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, r, hkv, d)).astype(np.float32)
    positions = offset + np.arange(c)
    want = np.asarray(jax_attn.prefill_attention_ring(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
        jnp.int32(offset + last), window=32))
    got = attn.prefill_attention_ring(_t(q), _t(k), _t(v), torch.from_numpy(positions),
                                      offset + last, window=32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ---------------------------------------------------------------------------
# the model, lock-step
# ---------------------------------------------------------------------------

_PAIRS: dict = {}


def _pair(name: str, decode_impl: str | None = None):
    """(reference model, params, port model, port params) on the weights of
    the base config's init from PRNGKey(0), quantized by the reference for
    +w4a8 (so the clip search's tie-breaks cannot decide a comparison)."""
    key = (name, decode_impl)
    if key not in _PAIRS:
        jcfg, tcfg = jax_get_config(name, reduced=True), get_config(name, reduced=True)
        if decode_impl:
            tcfg = tcfg.replace(decode_impl=decode_impl)
        jm = jax_build_model(jcfg)
        params = jm.init_params(jax.random.PRNGKey(0))
        if jcfg.w4a8_serve:
            params = jax_quantize_params(params)
        tm = build_model(tcfg, device="cpu")
        _PAIRS[key] = (jm, params, tm, from_jax(jax.tree.map(np.asarray, params), "cpu"))
    return _PAIRS[key]


_JITS: dict = {}


def _jax_greedy(name, prompts, steps):
    """The reference's prefill and greedy decode: logits [steps + 1, B, V],
    tokens [steps, B] and the final cache, as numpy."""
    jm, params, _, _ = _pair(name)
    if name not in _JITS:
        _JITS[name] = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
    prefill, step = _JITS[name]
    cache = jm.init_cache(prompts.shape[0], MAX_LEN, None)
    logits, cache = prefill(params, jnp.asarray(prompts), cache)
    out_l, out_t = [np.asarray(logits)], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out_t.append(np.asarray(tok))
        logits, cache = step(params, tok, cache)
        out_l.append(np.asarray(logits))
    return np.stack(out_l), np.stack(out_t), jax.tree.map(np.asarray, cache)


def _port_greedy(model, params, prompts, steps):
    with torch.inference_mode():
        cache = model.init_cache(prompts.shape[0], MAX_LEN)
        logits, cache = model.prefill(params, torch.from_numpy(prompts), cache)
        out_l, out_t = [logits.numpy().copy()], []
        for _ in range(steps):
            tok = logits.argmax(-1).to(torch.int32)
            out_t.append(tok.numpy().copy())
            logits, cache = model.decode_step(params, tok, cache)
            out_l.append(logits.numpy().copy())
    return np.stack(out_l), np.stack(out_t), cache


def _prompts(length):
    return np.random.default_rng(length).integers(0, 503, (2, length)).astype(np.int32)


@pytest.mark.parametrize("prompt_len", [20, 90, 150], ids=["below-window",
                                                           "window-to-ring", "wraps"])
@pytest.mark.parametrize("name", [BASE, RING, RING_Q])
def test_lockstep_matches_reference(name, prompt_len):
    """Port (decode_impl kernel: the kernel's plain version on the CPU)
    against the reference (its default blockwise decode): prefill + 16
    greedy steps, logits, tokens and the final cache."""
    _, _, tm, tparams = _pair(name, "kernel")
    prompts = _prompts(prompt_len)
    want_l, want_t, want_c = _jax_greedy(name, prompts, 16)
    got_l, got_t, got_c = _port_greedy(tm, tparams, prompts, 16)
    np.testing.assert_allclose(got_l, want_l, atol=1e-4)
    np.testing.assert_array_equal(got_t, want_t)
    assert set(got_c) == set(want_c)
    for key, want in want_c.items():
        got = got_c[key]
        assert tuple(got.shape) == want.shape, key
        if got.dtype in (torch.int8, torch.int32, torch.bfloat16):
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=key)
    if name != BASE:
        assert got_c["k"].shape[2] == 128 < MAX_LEN


@pytest.mark.parametrize("prompt_len", [20, 90, 150])
def test_ring_equals_linear_twin_in_the_port(prompt_len):
    """The ring drops out-of-window history by overwrite, the linear twin by
    masking: the same attended set, so the same logits and tokens."""
    _, _, ring, params = _pair(RING, "kernel")
    _, _, linear, _ = _pair(BASE, "kernel")
    prompts = _prompts(prompt_len + 1)
    ring_l, ring_t, _ = _port_greedy(ring, params, prompts, 16)
    lin_l, lin_t, _ = _port_greedy(linear, params, prompts, 16)
    np.testing.assert_allclose(ring_l, lin_l, atol=1e-5)
    np.testing.assert_array_equal(ring_t, lin_t)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

N_SLOTS, CHUNK = 2, 16
TRACE = dict(n_requests=4, prompt_len=(100, 200), max_new=(3, 12), seed=5)
_JAX_RUNS: dict = {}


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report["requests"]}


@pytest.mark.parametrize("decode_impl", ["kernel", "blockwise"])
@pytest.mark.parametrize("name", [RING, RING_Q])
def test_engine_matches_reference_engine(name, decode_impl):
    """Prompts of 100-200 tokens over a 128-slot ring (window 32, chunk 16):
    every prompt wraps the ring in chunked prefill; greedy tokens of the
    port's engine equal the reference engine's at decode_ticks 8."""
    jm, params, tm, tparams = _pair(name, decode_impl)
    if name not in _JAX_RUNS:
        eng = JaxEngine(jm, params, n_slots=N_SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        decode_ticks=8)
        _JAX_RUNS[name] = _tokens(eng.run(jax_poisson_trace(vocab_size=503, **TRACE)))
    eng = ContinuousBatchingEngine(tm, tparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                                   chunk=CHUNK, decode_ticks=8)
    assert eng.cache["k"].shape[2] == 128
    report = eng.run(poisson_trace(vocab_size=503, **TRACE))
    assert _tokens(report) == _JAX_RUNS[name]
    assert report["aggregate"]["n_retired"] == 4 and eng.pool.n_free == N_SLOTS
    # release zeroes the ring's rows (and, on +w4a8, its scales) entirely
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in eng.cache:
            assert not eng.cache[key].any(), key
    assert not eng.cache["len"].any()


def test_ring_sizing_and_bound_check():
    """init_cache(chunk=) sizes the ring as round128(window + chunk), capped
    at max_len, so the exactness bound ring_len >= window + chunk - 1
    holds; an engine over a ring sized without the chunk raises."""
    _, _, tm, tparams = _pair(RING)
    kw = dict(n_slots=1, max_len=MAX_LEN)
    assert ContinuousBatchingEngine(tm, tparams, chunk=8, **kw).cache["k"].shape[2] == 128
    assert ContinuousBatchingEngine(tm, tparams, chunk=128, **kw).cache["k"].shape[2] == 256
    wide = build_model(tm.cfg.replace(window=120), device="cpu")
    eng = ContinuousBatchingEngine(wide, tparams, n_slots=1, max_len=512, chunk=128)
    assert eng.cache["k"].shape[2] == 256 and 128 <= 256 - 120 + 1

    class ChunkBlind:          # a model whose ring ignores the chunk
        cfg = wide.cfg
        device = wide.device
        supports_ragged_serving = wide.supports_ragged_serving

        def init_cache(self, batch, max_len, chunk=None):
            return wide.init_cache(batch, max_len)
    with pytest.raises(ValueError, match="too large for the ring"):
        ContinuousBatchingEngine(ChunkBlind(), tparams, n_slots=1, max_len=512, chunk=64)


def test_kv_bytes_per_slot_scale_with_the_ring():
    _, _, ring, params = _pair(RING)
    _, _, linear, _ = _pair(BASE)

    def agg(model):
        eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=MAX_LEN, chunk=8)
        return eng.run([Request(prompt=np.arange(40, dtype=np.int32), max_new_tokens=3,
                                rid="r")])["aggregate"]
    a_ring, a_lin = agg(ring), agg(linear)
    assert (a_ring["kv_rows_per_slot"], a_lin["kv_rows_per_slot"]) == (128, MAX_LEN)
    assert a_ring["kv_bytes_per_slot"] * MAX_LEN == a_lin["kv_bytes_per_slot"] * 128


def test_mid_block_eos_on_the_wrap_boundary_backfills_exactly():
    """A request whose EOS lands on the decode tick that writes ring slot 0
    (the wrap boundary) retires inside an 8-tick block, and the request
    backfilled into its wrapped slot reproduces its lock-step stream. The
    EOS token comes from the port's own probe run."""
    _, _, tm, params = _pair(RING)
    # a random prompt: the stream of np.arange(125) repeats one token, so
    # no token of it can be an EOS that first appears at the boundary
    prompt_a = np.random.default_rng(0).integers(0, 503, 125).astype(np.int32)
    probe = ContinuousBatchingEngine(tm, params, n_slots=1, max_len=MAX_LEN, chunk=8)
    toks = probe.run([Request(prompt=prompt_a, max_new_tokens=12, rid="probe")])
    toks = toks["requests"][0]["tokens"]
    # token j comes from the decode write at position 125 + j - 1: j = 4
    # puts that write on slot 0
    j = 128 + 1 - len(prompt_a)
    eos = toks[j]
    assert eos not in toks[:j], "the probe's stream must not hold the EOS earlier"
    prompt_b = (np.arange(60, dtype=np.int32) * 3 + 1) % 503
    want_b = ServingEngine(tm, params, max_len=MAX_LEN, batch=1).generate(
        torch.from_numpy(prompt_b)[None], steps=4)[0].tolist()
    assert eos not in want_b
    eng = ContinuousBatchingEngine(tm, params, n_slots=1, max_len=MAX_LEN, chunk=8,
                                   eos_id=eos, decode_ticks=8)
    report = eng.run([Request(prompt=prompt_a, max_new_tokens=12, rid="a"),
                      Request(prompt=prompt_b, max_new_tokens=4, rid="b")])
    by_rid = {r["rid"]: r for r in report["requests"]}
    assert by_rid["a"]["tokens"] == toks[:j + 1]
    assert by_rid["a"]["finish_reason"] == "eos"
    assert by_rid["b"]["tokens"] == want_b
    assert eng.pool.n_free == 1
