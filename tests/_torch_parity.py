"""Parity helpers shared by the port's family tests
(``tests/test_torch_families.py``, ``tests/test_torch_moe.py``): a reduced
config built on both sides from the reference's weights, and the checks of
the lock-step path, the continuous path's model functions and the
continuous engine against the reference, float32, logits and float caches
within 1e-4 absolute, int8 codes, lengths and tokens exactly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace

ATOL = 1e-4
BATCH, PROMPT, STEPS, MAX_LEN = 3, 12, 10, 64
N_SLOTS, CHUNK = 2, 8

_PAIRS: dict = {}


def pair(name: str, decode_impl: str = "kernel"):
    """(reference model, its params, port model, port params) of a reduced
    config on the same weights (the reference's init from PRNGKey(0))."""
    key = (name, decode_impl)
    if key not in _PAIRS:
        jcfg = jax_get_config(name, reduced=True).replace(decode_impl=decode_impl)
        jm = jax_build_model(jcfg)
        params = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(get_config(name, reduced=True).replace(decode_impl=decode_impl),
                         device="cpu")
        _PAIRS[key] = (jm, params, tm, from_jax(jax.tree.map(np.asarray, params), "cpu"))
    return _PAIRS[key]


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def check_cache(jcache, tcache, what):
    assert set(tcache) == set(jcache), what
    for key, want in jcache.items():
        want, got = np.asarray(want), tcache[key]
        assert tuple(got.shape) == want.shape, (what, key)
        if got.dtype == torch.int8 or key == "len":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what}: {key}")
        elif got.dtype == torch.bfloat16:                       # int8 scale planes
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=f"{what}: {key}")


def close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, err_msg=what)


def check_lockstep(name):
    """Logits and caches of a prefill and two decode steps, then greedy
    ``generate`` tokens, against the reference's."""
    jm, params, tm, tparams = pair(name)
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (BATCH, PROMPT))
    prompts = prompts.astype(np.int32)
    jc, tc = jm.init_cache(BATCH, MAX_LEN), tm.init_cache(BATCH, MAX_LEN)
    check_cache(jc, tc, "init_cache")
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jc)
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, torch.from_numpy(prompts), tc)
    close(tl, jl, "prefill logits")
    check_cache(jc, tc, "prefill")
    decode = jax.jit(jm.decode_step)
    for step in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = decode(params, tok, jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, torch.from_numpy(np.asarray(tok)), tc)
        close(tl, jl, f"decode step {step} logits")
        check_cache(jc, tc, f"decode step {step}")
    want = JaxServingEngine(jm, params, max_len=MAX_LEN, batch=BATCH).generate(
        jnp.asarray(prompts), steps=STEPS)
    got = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=BATCH).generate(
        torch.from_numpy(prompts), steps=STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_ragged(name):
    """The continuous path's model functions on both sides: three chunks of
    one slot, one batched advance with an invalid row, two commits, a ragged
    step with a parked row, a K = 4 block with a mid-block EOS, a release."""
    jm, params, tm, tparams = pair(name)
    vocab, n = jm.cfg.vocab_size, 3
    rng = np.random.default_rng(11)
    jc, tc = jm.init_cache(n, MAX_LEN, chunk=CHUNK), tm.init_cache(n, MAX_LEN, chunk=CHUNK)
    prompt = rng.integers(0, vocab, 20).astype(np.int32)
    chunk_fn = jax.jit(jm.prefill_chunk)
    for off in range(0, 20, CHUNK):
        part = np.zeros(CHUNK, np.int32)
        part[:min(CHUNK, 20 - off)] = prompt[off:off + CHUNK]
        last = min(CHUNK - 1, 19 - off)
        jl, jc = chunk_fn(params, jnp.asarray(part), jc, jnp.int32(1), jnp.int32(off),
                          jnp.int32(last))
        with torch.inference_mode():
            tl, tc = tm.prefill_chunk(tparams, torch.from_numpy(part), tc, 1, off, last)
        close(tl, jl, f"prefill_chunk logits at offset {off}")
        check_cache(jc, tc, f"prefill_chunk at offset {off}")

    toks = np.zeros((n, CHUNK), np.int32)
    toks[0, :6] = rng.integers(0, vocab, 6)
    toks[2] = rng.integers(0, vocab, CHUNK)
    slots, offs, lasts, valid = [0, 0, 2], [0, 0, 0], [5, 0, 7], [True, False, False]
    jl, jc = jax.jit(jm.prefill_chunks_batched)(
        params, jnp.asarray(toks), jc, jnp.asarray(slots, jnp.int32),
        jnp.asarray(offs, jnp.int32), jnp.asarray(lasts, jnp.int32), jnp.asarray(valid))
    with torch.inference_mode():
        tl, tc = tm.prefill_chunks_batched(tparams, torch.from_numpy(toks), tc, slots,
                                           offs, lasts, valid)
    close(tl, jl, "prefill_chunks_batched logits")
    check_cache(jc, tc, "prefill_chunks_batched")
    jc = jax.jit(jm.finalize_slot)(jax.jit(jm.finalize_slot)(jc, jnp.int32(1), jnp.int32(20)),
                                   jnp.int32(0), jnp.int32(6))
    tc = tm.finalize_slot(tm.finalize_slot(tc, 1, 20), 0, 6)
    check_cache(jc, tc, "finalize_slot")

    tok, active = np.array([3, 7, 11], np.int32), np.array([True, True, False])
    jl, jc = jax.jit(jm.decode_step)(params, jnp.asarray(tok), jc, jnp.asarray(active))
    with torch.inference_mode():
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc, torch.from_numpy(active))
    close(tl, jl, "decode_step(active=) logits")
    check_cache(jc, tc, "decode_step(active=)")

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    args = dict(active=np.array([True, True, False]), budget=np.array([6, 4, 0], np.int32),
                serials=np.array([0, 1, 2], np.int32), emitted=np.array([1, 1, 0], np.int32))
    multi = jax.jit(jm.decode_multi, static_argnums=(7,), static_argnames=("eos_id",))
    probe, *_ = multi(params, jnp.asarray(tok), jax.tree.map(jnp.copy, jc),
                      *map(jnp.asarray, args.values()), 4)
    eos = int(np.asarray(probe)[1, 0])
    jb, ja, je, jc = multi(params, jnp.asarray(tok), jc, *map(jnp.asarray, args.values()), 4,
                           eos_id=eos)
    with torch.inference_mode():
        tb, ta, te, tc = tm.decode_multi(tparams, torch.from_numpy(tok), tc,
                                         *map(torch.from_numpy, args.values()), 4,
                                         eos_id=eos)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    check_cache(jc, tc, "decode_multi")
    jc = jax.jit(jm.release_slot)(jc, jnp.int32(1))
    check_cache(jc, tm.release_slot(tc, 1), "release_slot")


def check_engine(name, ticks):
    """Greedy tokens of the port's engine equal the reference engine's on
    the conformance trace (4 requests, 2 slots, max_len 64, chunk 8)."""
    jm, params, tm, tparams = pair(name)
    kw = dict(n_requests=4, vocab_size=jm.cfg.vocab_size, prompt_len=(3, 18),
              max_new=(3, 12), seed=5)
    want = JaxEngine(jm, params, n_slots=N_SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                     decode_ticks=ticks).run(jax_poisson_trace(**kw))
    got = ContinuousBatchingEngine(tm, tparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                                   chunk=CHUNK, decode_ticks=ticks).run(poisson_trace(**kw))
    tokens = lambda report: {r["rid"]: r["tokens"] for r in report["requests"]}
    assert tokens(got) == tokens(want)
    assert got["aggregate"]["n_retired"] == 4
