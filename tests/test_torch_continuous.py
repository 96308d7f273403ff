"""The port's continuous-batching path against the reference at reduced size.

Model level, for llama2-7b and llama2-7b+w4a8 with ``decode_impl`` kernel
(the port runs its kernels' plain versions on the CPU, the reference its
Pallas kernels in interpret mode) and blockwise: the same converted weights
and inputs go through ``prefill_chunk`` (three chunks of one slot),
``prefill_chunks_batched`` (one row invalid), ``finalize_slot``,
``decode_step(active=)`` (one row parked), ``decode_multi`` (K = 4, an EOS
mid-block) and ``release_slot`` on both sides. Logits agree within 1e-5
absolute (float32 end to end; summation orders differ, nothing else),
float caches within 1e-5, int8 codes, lengths and token blocks exactly, the
bf16 int8 scales exactly.

Engine level, on the conformance recipe (``poisson_trace(n_requests=4,
seed=5, prompt_len=(3, 18), max_new=(3, 12))``, 2 slots, ``max_len`` 64,
chunk 8): greedy tokens of the port's engine equal the reference engine's
and the port's lock-step ``ServingEngine(batch=1)``'s, at decode_ticks 1
and 8; seeded sampled tokens equal the reference engine's and do not move
with the tick horizon; the +w4a8 exact tiers of the reference's own suite
(one-chunk prompts equal quantized lock-step; batch composition invisible);
a mid-block EOS backfills; release leaves int8 rows and scales zero (but
for the parking tail row, which inactive rows go on writing).
+w4a8 engines get the reference's quantized leaves, so that the clip
search's tie-breaks cannot decide a comparison.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.serving import (ContinuousBatchingEngine, Request, ServingEngine,
                                 poisson_trace)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
CONFIGS = ["llama2-7b", "llama2-7b+w4a8"]
N_SLOTS, MAX_LEN, CHUNK = 2, 64, 8

_PAIRS: dict = {}


def _pair(name: str, decode_impl: str | None = None):
    """(reference model, its params, port model, port params) on the same
    weights: the base config's init from PRNGKey(0), quantized by the
    reference for +w4a8."""
    key = (name, decode_impl)
    if key not in _PAIRS:
        jcfg = jax_get_config(name, reduced=True)
        tcfg = get_config(name, reduced=True)
        if decode_impl:
            jcfg, tcfg = (c.replace(decode_impl=decode_impl) for c in (jcfg, tcfg))
        jm = jax_build_model(jcfg)
        params = jm.init_params(jax.random.PRNGKey(0))
        if jcfg.w4a8_serve:
            params = jax_quantize_params(params)
        tm = build_model(tcfg, device="cpu")
        _PAIRS[key] = (jm, params, tm, from_jax(jax.tree.map(np.asarray, params), "cpu"))
    return _PAIRS[key]


def _check_cache(jcache, tcache, what):
    assert set(tcache) == set(jcache), what
    for key, want in jcache.items():
        want = np.asarray(want)
        got = tcache[key]
        assert tuple(got.shape) == want.shape, (what, key)
        if got.dtype == torch.int8 or key == "len":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what}: {key}")
        elif got.dtype == torch.bfloat16:                       # int8 scale planes
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                       err_msg=f"{what}: {key}")


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_impl", ["kernel", "blockwise"])
@pytest.mark.parametrize("name", CONFIGS)
def test_ragged_model_functions_match_reference(name, decode_impl):
    jm, params, tm, tparams = _pair(name, decode_impl)
    vocab = jm.cfg.vocab_size
    rng = np.random.default_rng(11)
    n_slots = 3
    jc = jm.init_cache(n_slots, MAX_LEN, chunk=CHUNK)
    tc = tm.init_cache(n_slots, MAX_LEN, chunk=CHUNK)
    _check_cache(jc, tc, "init_cache")

    # three chunks of one slot (the last padded): slot 1, prompt of 20
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
        _close(tl, jl, f"prefill_chunk logits at offset {off}")
        _check_cache(jc, tc, f"prefill_chunk at offset {off}")

    # one batched advance: slot 0's first chunk (6 tokens), slot 2 invalid
    toks = np.zeros((n_slots, CHUNK), np.int32)
    toks[0, :6] = rng.integers(0, vocab, 6)
    toks[2] = rng.integers(0, vocab, CHUNK)
    slots, offs, lasts, valid = [0, 0, 2], [0, 0, 0], [5, 0, 7], [True, False, False]
    jl, jc = jax.jit(jm.prefill_chunks_batched)(
        params, jnp.asarray(toks), jc, jnp.asarray(slots, jnp.int32),
        jnp.asarray(offs, jnp.int32), jnp.asarray(lasts, jnp.int32), jnp.asarray(valid))
    with torch.inference_mode():
        tl, tc = tm.prefill_chunks_batched(tparams, torch.from_numpy(toks), tc, slots,
                                           offs, lasts, valid)
    _close(tl, jl, "prefill_chunks_batched logits")
    assert not tl[1:].any(), "invalid rows give zero logits"
    _check_cache(jc, tc, "prefill_chunks_batched")

    jc = jax.jit(jm.finalize_slot)(jc, jnp.int32(1), jnp.int32(20))
    jc = jax.jit(jm.finalize_slot)(jc, jnp.int32(0), jnp.int32(6))
    tc = tm.finalize_slot(tm.finalize_slot(tc, 1, 20), 0, 6)
    _check_cache(jc, tc, "finalize_slot")

    # one ragged step: slot 2 parked on the tail row
    tok = np.array([3, 7, 11], np.int32)
    active = np.array([True, True, False])
    jl, jc = jax.jit(jm.decode_step)(params, jnp.asarray(tok), jc, jnp.asarray(active))
    with torch.inference_mode():
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc,
                                torch.from_numpy(active))
    _close(tl, jl, "decode_step(active=) logits")
    _check_cache(jc, tc, "decode_step(active=)")

    # K = 4 ticks, greedy; row 0 meets EOS at its second tick (EOS taken from
    # a probe block on a copy of the cache), row 1 its budget at the third
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
    assert (tb[2:, 0] == -1).all() and (tb[3:, 1] == -1).all() and (tb[:, 2] == -1).all()
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _check_cache(jc, tc, "decode_multi")

    jc = jax.jit(jm.release_slot)(jc, jnp.int32(1))
    tc = tm.release_slot(tc, 1)
    _check_cache(jc, tc, "release_slot")


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def _trace(vocab, *, seed=5, prompt_len=(3, 18), max_new=(3, 12), n=4):
    return poisson_trace(n_requests=n, vocab_size=vocab, prompt_len=prompt_len,
                         max_new=max_new, seed=seed)


def _port_engine(tm, tparams, **kw):
    return ContinuousBatchingEngine(tm, tparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                                    chunk=CHUNK, **kw)


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report["requests"]}


_JAX_RUNS: dict = {}


def _jax_run(name, ticks=1, temperature=0.0, seed=0):
    """The reference engine's tokens on the conformance trace (cached)."""
    key = (name, ticks, temperature, seed)
    if key not in _JAX_RUNS:
        jm, params, _, _ = _pair(name)
        trace = jax_poisson_trace(n_requests=4, vocab_size=jm.cfg.vocab_size,
                                  prompt_len=(3, 18), max_new=(3, 12), seed=5)
        eng = JaxEngine(jm, params, n_slots=N_SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        decode_ticks=ticks, temperature=temperature, seed=seed)
        _JAX_RUNS[key] = _tokens(eng.run(trace))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("ticks", [1, 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_matches_reference_engine_and_lockstep(name, ticks):
    """Greedy tokens of the port's engine equal the reference engine's on
    the same trace, and each request's own lock-step generation (the
    reference's exact tier; for +w4a8 chunked prefill re-reads a longer
    prompt's prefix through int8, so lock-step is held to one-chunk
    prompts, below)."""
    jm, params, tm, tparams = _pair(name)
    report = _port_engine(tm, tparams, decode_ticks=ticks).run(_trace(jm.cfg.vocab_size))
    got = _tokens(report)
    assert got == _jax_run(name, ticks)
    assert report["aggregate"]["n_retired"] == 4
    if tm.cfg.w4a8_serve:
        return
    ref = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=1)
    for r in _trace(tm.cfg.vocab_size):
        want = ref.generate(torch.from_numpy(r.prompt)[None], steps=r.max_new_tokens)
        assert got[r.rid] == want[0].tolist(), r.rid


def test_w4a8_single_chunk_prompts_match_lockstep_exactly():
    _, _, tm, tparams = _pair("llama2-7b+w4a8")
    trace = _trace(tm.cfg.vocab_size, seed=6, prompt_len=(3, 8))
    got = _tokens(_port_engine(tm, tparams, decode_ticks=8).run(trace))
    ref = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=1)
    for r in trace:
        want = ref.generate(torch.from_numpy(r.prompt)[None], steps=r.max_new_tokens)
        assert got[r.rid] == want[0].tolist(), r.rid


def test_w4a8_batch_composition_is_invisible():
    _, _, tm, tparams = _pair("llama2-7b+w4a8")
    trace = _trace(tm.cfg.vocab_size, seed=6)
    got = _tokens(_port_engine(tm, tparams, decode_ticks=8).run(trace))
    for r in trace:
        solo = _port_engine(tm, tparams, decode_ticks=8).run([r])
        assert got[r.rid] == solo["requests"][0]["tokens"], r.rid


def test_sampled_tokens_match_reference_and_ignore_the_horizon():
    """temperature 0.8, seed 3: the request-intrinsic Gumbel keys draw the
    reference engine's tokens, at every tick horizon."""
    jm, _, tm, tparams = _pair("llama2-7b")
    want = _jax_run("llama2-7b", 1, temperature=0.8, seed=3)
    greedy = _jax_run("llama2-7b", 1)
    assert want != greedy, "sampling must move some token"
    for ticks in (1, 4, 8):
        eng = _port_engine(tm, tparams, decode_ticks=ticks, temperature=0.8, seed=3)
        assert _tokens(eng.run(_trace(jm.cfg.vocab_size))) == want, ticks


def test_mid_block_eos_backfills():
    """EOS from the port's own probe run: request a emits it at its second
    token and retires inside an 8-tick block; b backfills the slot."""
    _, _, tm, tparams = _pair("llama2-7b")
    prompt = np.arange(5, dtype=np.int32)
    probe = ContinuousBatchingEngine(tm, tparams, n_slots=1, max_len=MAX_LEN, chunk=CHUNK)
    toks = probe.run([Request(prompt=prompt, max_new_tokens=8, rid="probe")])
    toks = toks["requests"][0]["tokens"]
    eng = ContinuousBatchingEngine(tm, tparams, n_slots=1, max_len=MAX_LEN, chunk=CHUNK,
                                   eos_id=toks[1], decode_ticks=8)
    report = eng.run([Request(prompt=prompt, max_new_tokens=8, rid="a"),
                      Request(prompt=prompt + 1, max_new_tokens=3, rid="b")])
    by_rid = {r["rid"]: r for r in report["requests"]}
    assert by_rid["a"]["tokens"] == toks[:2] and by_rid["a"]["finish_reason"] == "eos"
    assert by_rid["b"]["n_tokens"] >= 1
    assert eng.pool.n_free == 1


def test_release_zeroes_int8_rows_and_report_counts():
    _, _, tm, tparams = _pair("llama2-7b+w4a8")
    eng = _port_engine(tm, tparams, decode_ticks=4)
    report = eng.run(_trace(tm.cfg.vocab_size))
    agg = report["aggregate"]
    assert agg["n_retired"] == 4 and eng.pool.n_free == N_SLOTS
    # one sync per decode block and one per first token
    assert agg["host_syncs"] == agg["decode_dispatches"] + agg["n_retired"]
    assert agg["kv_bytes_per_slot"] == sum(
        eng.cache[k].numel() * eng.cache[k].element_size()
        for k in ("k", "v", "k_scale", "v_scale")) // N_SLOTS
    # every row but the parking tail (which inactive rows keep writing)
    for key in ("k", "v"):
        assert not eng.cache[key][:, :, :-1].any(), key
    for key in ("k_scale", "v_scale"):
        assert not eng.cache[key][..., :-1].any(), key
    assert not eng.cache["len"].any()


def test_engine_defers_unported_options():
    """The options once deferred are ported: the engine takes
    ``telemetry=``, ``overload=``, ``faults=`` and ``auditor=`` (none
    raises), and with each left at None it holds no sink, plan or auditor,
    so its host loop is the bare one."""
    from repro_torch.serving import EngineAuditor, FaultPlan, OverloadConfig, Telemetry
    _, _, tm, tparams = _pair("llama2-7b")
    for kw in ({"telemetry": Telemetry()}, {"overload": OverloadConfig(max_queue=4)},
               {"faults": FaultPlan([])}, {"auditor": EngineAuditor()}):
        eng = _port_engine(tm, tparams, **kw)
        (name, value), = kw.items()
        held = {"telemetry": eng.tel, "overload": eng.sched.overload,
                "faults": eng.faults, "auditor": eng.auditor}
        assert held[name] is value
    bare = _port_engine(tm, tparams)
    assert (bare.tel, bare._sink, bare.sched.overload, bare.faults, bare.auditor) == (None,) * 5


def test_serve_cli_continuous_on_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama2-7b",
         "--reduced", "--device", "cpu", "--continuous", "--requests", "4",
         "--n-slots", "2", "--max-len", "64", "--chunk", "8", "--metrics-out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert metrics["mode"] == "continuous" and metrics["device"] == "cpu"
    assert metrics["n_requests"] == 4 and metrics["generated_tokens"] > 0
    assert json.loads(out.read_text())["metrics"] == metrics
