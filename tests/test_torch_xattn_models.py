"""The port's cross-attention models against the reference at reduced size:
whisper-small (an encoder-decoder: a bidirectional encoder over the
frames, a cross attention in every decoder layer) and llama-3.2-vision-90b
(a dedicated gated cross layer after every 4 self layers), plain and
``+w4a8``.

Every cross gate is 0.5 in the reference's tree before conversion
(``_torch_parity.XATTN_GATE``): at the reference's init of 0 a wrong cross
read would still match. float32, ``decode_impl="kernel"`` (the port runs
its kernels' plain versions on the CPU: the pooled read the blockwise pooled
loop, as the reference reads it), the reference's weights converted leaf
for leaf: the encoder over padded frames; lock-step prefill and decode
logits with heterogeneous source lengths (one row of length 0) within
1e-5, caches within 1e-4 and greedy tokens exactly; sourceless serving;
the source-KV pool's model functions (ingest, assign, chunked prefill,
ragged decode, a K = 4 block, release zeroing the entry); the continuous
engine's tokens and pool counters over a trace with sources shared by
pairs; a backfill that never reads its predecessor's source; the
reference's rejection codes; ``+w4a8`` lock-step held teacher-forced
(``_torch_parity.NEAR_TIES``); the CLI; and at gate 0 the cross term
vanishing exactly on both sides."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CHUNK, JaxEngine, JaxServingEngine, N_SLOTS, XATTN_GATE,
                           check_cache, check_engine, check_lockstep, close, flat, pair,
                           with_gates)
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model, needs_source, source_spec
from repro_torch.serving import ContinuousBatchingEngine, Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["whisper-small", "llama-3.2-vision-90b"]
LOGIT_ATOL = 1e-5
B, PROMPT, STEPS, MAX_LEN = 3, 9, 6, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sources(cfg, rng, n=B):
    """n sources padded to S_src and their lengths: one full, one of 0
    (no source), the others in between."""
    src = rng.standard_normal((n, cfg.source_len, cfg.d_model)).astype(np.float32)
    lens = rng.integers(1, cfg.source_len, n).astype(np.int32)
    lens[0], lens[-1] = cfg.source_len, 0
    return src, lens


def _trace_kw(cfg):
    return dict(source_len=(max(1, cfg.source_len // 4), cfg.source_len),
                source_dim=cfg.d_model, source_share=2)


@pytest.mark.parametrize("name", NAMES)
def test_config_and_tree_layout(name):
    """``build_model`` builds both on the CPU; the converted tree is the
    reference's leaf for leaf, and the port's own init has the reference's
    tree layout (paths, shapes) with every gate 0."""
    jm, params, tm, tparams = pair(name)
    cfg = tm.cfg
    assert needs_source(cfg) and source_spec(cfg, 2)[0] == (2, cfg.source_len, cfg.d_model)
    want = dict(flat(jax.tree.map(np.asarray, params)))
    got = dict(flat(tparams))
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key].numpy(), leaf, err_msg=key)
    own = dict(flat(build_model(cfg, device="cpu").init_params(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    gates = [k for k in own if k.endswith("cross/gate")]
    assert gates and all(not own[k].any() for k in gates)


def test_whisper_encoder_over_padded_frames():
    jm, params, tm, tparams = pair("whisper-small")
    src, lens = _sources(tm.cfg, np.random.default_rng(3))
    lens[-1] = 5
    want = np.asarray(jax.jit(jm.encode)(params, jnp.asarray(src),
                                         source_len=jnp.asarray(lens)))
    with torch.inference_mode():
        got = tm.encode(tparams, torch.from_numpy(src), torch.from_numpy(lens)).numpy()
    for row, n in enumerate(lens):           # the valid positions of each row
        np.testing.assert_allclose(got[row, :n], want[row, :n], atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_lockstep_with_sources(name):
    """Prefill with heterogeneous source lengths, then decode steps: logits
    and every cache plane (the per-row ``cross_k`` / ``cross_v`` and
    ``source_len`` among them); then ``generate``'s greedy tokens."""
    jm, params, tm, tparams = pair(name)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    src, lens = _sources(jm.cfg, rng)
    s_src = jm.cfg.source_len
    jc, tc = jm.init_cache(B, MAX_LEN, s_src), tm.init_cache(B, MAX_LEN, s_src)
    check_cache(jc, tc, "init_cache")
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jc, jnp.asarray(src),
                                 jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, torch.from_numpy(prompts), tc, torch.from_numpy(src),
                            torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    check_cache(jc, tc, "prefill")
    decode = jax.jit(jm.decode_step)
    for step in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = decode(params, tok, jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        check_cache(jc, tc, f"decode step {step}")
    want = JaxServingEngine(jm, params, max_len=MAX_LEN, batch=B, source_len=s_src).generate(
        jnp.asarray(prompts), steps=STEPS, source=jnp.asarray(src), source_len=jnp.asarray(lens))
    got = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=B, source_len=s_src).generate(
        torch.from_numpy(prompts), steps=STEPS, source=torch.from_numpy(src),
        source_len=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_sourceless_prefill_and_decode(name):
    """No source: the cross terms are skipped (whisper reads its zeroed
    per-row rows, vision has none), a vision cross layer still applies its
    MLP; logits, caches and tokens equal the reference's."""
    check_lockstep(name, max_len=MAX_LEN)


@pytest.mark.parametrize("name", NAMES)
def test_pool_model_functions(name):
    """The source-KV pool's model functions on both sides: two sources
    ingested into entries 2 and 0 (E = 3, one shorter than the pool's
    rows), slots pointed at them (two slots share entry 2), chunked prefill
    of a padded prompt against its entry, a ragged decode step with a
    parked row, a K = 4 block, then the entry released: zero rows, scales
    and src_len."""
    jm, params, tm, tparams = pair(name)
    cfg, rng = jm.cfg, np.random.default_rng(5)
    n, s_src = 3, cfg.source_len
    jc = jm.init_cache(n, MAX_LEN, s_src, n_sources=n, chunk=CHUNK)
    tc = tm.init_cache(n, MAX_LEN, s_src, n_sources=n, chunk=CHUNK)
    check_cache(jc, tc, "init_cache")
    src, _ = _sources(cfg, rng, 2)
    for (entry, length), s in zip(((2, s_src), (0, s_src // 3)), src):
        jc = jax.jit(jm.ingest_source)(params, jnp.asarray(s), jc, jnp.int32(entry),
                                       jnp.int32(length))
        tc = tm.ingest_source(tparams, torch.from_numpy(s), tc, entry, length)
        check_cache(jc, tc, f"ingest_source into entry {entry}")
    for slot, entry in ((0, 2), (1, 0), (2, 2)):
        jc = jax.jit(jm.assign_source)(jc, jnp.int32(slot), jnp.int32(entry))
        tc = tm.assign_source(tc, slot, entry)
    check_cache(jc, tc, "assign_source")
    chunk_fn = jax.jit(jm.prefill_chunk)
    for slot, plen in ((0, 11), (1, 5)):
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        for off in range(0, plen, CHUNK):
            part = np.zeros(CHUNK, np.int32)
            part[:min(CHUNK, plen - off)] = prompt[off:off + CHUNK]
            last = min(CHUNK - 1, plen - 1 - off)
            jl, jc = chunk_fn(params, jnp.asarray(part), jc, jnp.int32(slot), jnp.int32(off),
                              jnp.int32(last))
            with torch.inference_mode():
                tl, tc = tm.prefill_chunk(tparams, torch.from_numpy(part), tc, slot, off, last)
            close(tl, jl, f"prefill_chunk slot {slot} offset {off}")
            check_cache(jc, tc, f"prefill_chunk slot {slot} offset {off}")
        jc = jax.jit(jm.finalize_slot)(jc, jnp.int32(slot), jnp.int32(plen))
        tc = tm.finalize_slot(tc, slot, plen)
    tok, active = np.array([3, 7, 11], np.int32), np.array([True, True, False])
    jl, jc = jax.jit(jm.decode_step)(params, jnp.asarray(tok), jc, jnp.asarray(active))
    with torch.inference_mode():
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc, torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    check_cache(jc, tc, "decode_step(active=)")
    args = dict(active=np.array([True, True, False]), budget=np.array([6, 4, 0], np.int32),
                serials=np.array([0, 1, 2], np.int32), emitted=np.array([1, 1, 0], np.int32))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    multi = jax.jit(jm.decode_multi, static_argnums=(7,))
    jb, ja, je, jc = multi(params, jnp.asarray(tok), jc, *map(jnp.asarray, args.values()), 4)
    with torch.inference_mode():
        tb, ta, te, tc = tm.decode_multi(tparams, torch.from_numpy(tok), tc,
                                         *map(torch.from_numpy, args.values()), 4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    check_cache(jc, tc, "decode_multi")
    jc = jax.jit(jm.release_source)(jc, jnp.int32(2))
    tc = tm.release_source(tc, 2)
    check_cache(jc, tc, "release_source")
    assert int(tc["src_len"][2]) == 0
    assert all(not tc[k][:, 2].any() for k in tc if k.startswith("src_") and tc[k].dim() > 1)


@pytest.mark.parametrize("ticks", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_continuous_engine_with_sources(name, ticks):
    """The engine over a trace with heterogeneous sources, each shared by
    two consecutive requests: tokens, source ingests and shares equal the
    reference engine's."""
    cfg = get_config(name, reduced=True)
    got, want = check_engine(name, ticks, n_requests=6, **_trace_kw(cfg))
    for key in ("source_ingests", "source_shares", "src_rows_per_entry",
                "kv_bytes_per_slot"):
        assert got[key] == want[key], key
    assert got["source_shares"] > 0


def test_backfill_never_reads_its_predecessors_source():
    """One slot, so each request backfills the last one's slot and pool
    entry: a request without a source, and one with a shorter source, get
    the tokens they get alone; the entry is all zeros at the end."""
    _, _, tm, tparams = pair("llama-3.2-vision-90b")
    cfg, rng = tm.cfg, np.random.default_rng(9)
    src, _ = _sources(cfg, rng, 2)

    def req(rid, source=None):
        return Request(prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                       max_new_tokens=5, rid=rid, source=source)
    first, bare, short = req("a", src[0]), req("b"), req("c", src[1][:5])

    def run(reqs):
        eng = ContinuousBatchingEngine(tm, tparams, n_slots=1, max_len=MAX_LEN, chunk=CHUNK)
        return {r["rid"]: r["tokens"] for r in eng.run(reqs)["requests"]}, eng
    together, eng = run([first, bare, short])
    assert together["b"] == run([bare])[0]["b"]
    assert together["c"] == run([short])[0]["c"]
    assert not eng.cache["src_len"].any()
    assert all(not eng.cache[k].any() for k in ("src_k", "src_v"))


def test_rejections_match_reference():
    """A source longer than the pool's rows and a source id without
    features are rejected at submit with the reference's codes."""
    jm, params, tm, tparams = pair("whisper-small")
    cfg, rng = jm.cfg, np.random.default_rng(2)
    too_long = rng.standard_normal((cfg.source_len + 1, cfg.d_model)).astype(np.float32)
    specs = [dict(rid="long", source=too_long), dict(rid="noid", source_id="img-1"),
             dict(rid="ok")]
    prompt = np.arange(4, dtype=np.int32)
    reports = []
    for engine, request in ((ContinuousBatchingEngine(tm, tparams, n_slots=N_SLOTS,
                                                      max_len=MAX_LEN, chunk=CHUNK), Request),
                            (JaxEngine(jm, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                                       chunk=CHUNK), JaxRequest)):
        report = engine.run([request(prompt=prompt, max_new_tokens=3, **kw) for kw in specs])
        reports.append({r["rid"]: (r["status"], r["code"], r["tokens"])
                        for r in report["requests"]})
    assert reports[0] == reports[1]
    assert reports[0]["long"][1] == "source_too_long"
    assert reports[0]["noid"][1] == "source_id_without_source"


@pytest.mark.parametrize("name", NAMES)
def test_w4a8_lockstep_near_ties(name):
    """+w4a8 with sources: the int8 self KV and the W4A8 projections (the
    cross layers' and the encoder's too); greedy tokens held
    teacher-forced, a flip allowed only at a near-tie (NEAR_TIES)."""
    from repro.models.quantized import quantize_params as jax_quantize_params
    from repro_torch.models.quantized import quantize_params
    jm, params, tm, tparams = pair(name + "+w4a8")
    qparams, tqparams = jax_quantize_params(params), quantize_params(tparams)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    src, lens = _sources(jm.cfg, rng)
    s_src = jm.cfg.source_len
    jl, jc = jax.jit(jm.prefill)(qparams, jnp.asarray(prompts), jm.init_cache(B, MAX_LEN, s_src),
                                 jnp.asarray(src), jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = tm.prefill(tqparams, torch.from_numpy(prompts),
                            tm.init_cache(B, MAX_LEN, s_src), torch.from_numpy(src),
                            torch.from_numpy(lens))
    decode = jax.jit(jm.decode_step)
    for step in range(STEPS):
        want, got = np.asarray(jl, np.float32), tl.numpy()
        diff = np.abs(want - got).max(-1)
        top2 = np.sort(want, -1)[:, -2:]
        differ = want.argmax(-1) != got.argmax(-1)
        assert (top2[:, 1] - top2[:, 0] <= 2 * diff)[differ].all(), (name, step)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = decode(qparams, tok, jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tqparams, torch.from_numpy(np.array(tok)), tc)


@pytest.mark.parametrize("name", NAMES)
def test_w4a8_pool_ingest_int8(name):
    """+w4a8's int8 pool: an ingested entry's codes (up to two one step off
    at a rounding near-tie, NEAR_TIES) and bf16 scales, zero past the
    source's length, as the reference's."""
    from repro.models.quantized import quantize_params as jax_quantize_params
    from repro_torch.models.quantized import quantize_params
    jm, params, tm, tparams = pair(name + "+w4a8")
    qparams, tqparams = jax_quantize_params(params), quantize_params(tparams)
    s_src = jm.cfg.source_len
    src, _ = _sources(jm.cfg, np.random.default_rng(6), 1)
    jc = jax.jit(jm.ingest_source)(qparams, jnp.asarray(src[0]),
                                   jm.init_cache(2, MAX_LEN, s_src, n_sources=2),
                                   jnp.int32(1), jnp.int32(s_src - 4))
    tc = tm.ingest_source(tqparams, torch.from_numpy(src[0]),
                          tm.init_cache(2, MAX_LEN, s_src, n_sources=2), 1, s_src - 4)
    assert tc["src_k"].dtype == torch.int8 and tc["src_k_scale"].dtype == torch.bfloat16
    for key in ("src_k_scale", "src_v_scale"):      # scales: exact, or where a code flipped
        ok = tc[key].float().numpy() == np.asarray(jc[key], np.float32)
        assert ok.mean() > 0.99, key
    check_cache({k: v for k, v in jc.items() if k not in ("src_k_scale", "src_v_scale")},
                {k: v for k, v in tc.items() if k not in ("src_k_scale", "src_v_scale")},
                "ingest", code_flips=2)
    assert not tc["src_k"][:, 1, s_src - 4:].any() and not tc["src_k_scale"][:, 1, :, s_src - 4:].any()


@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
def test_serve_cli_whisper_on_cpu(tmp_path, continuous):
    import json
    out = tmp_path / "metrics.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = (["--continuous", "--requests", "4", "--n-slots", "2", "--max-len", "64",
              "--chunk", "8"] if continuous else ["--batch", "2", "--gen", "4"])
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "whisper-small",
         "--reduced", "--device", "cpu", "--prompt-len", "8", "--metrics-out", str(out),
         *extra], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    metrics = json.loads(out.read_text())
    if continuous:
        agg = metrics["metrics"]
        assert agg["n_retired"] + agg["n_rejected"] == 4
        assert agg["source_ingests"] >= 1 and agg["source_shares"] >= 1
    else:
        assert metrics["generated"] == 4 and metrics["tokens_per_s"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_gate_zero_cross_term_vanishes(name):
    """At the reference's init (every gate 0) the cross term is exactly 0:
    prefill with a source gives bitwise the logits without one, in the
    port and in the reference alike."""
    jm, params, tm, tparams = pair(name)
    params = with_gates(params, 0.0)
    tparams = from_jax(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    src, lens = _sources(jm.cfg, rng)
    s_src = jm.cfg.source_len
    with torch.inference_mode():
        with_src, _ = tm.prefill(tparams, torch.from_numpy(prompts),
                                 tm.init_cache(B, MAX_LEN, s_src), torch.from_numpy(src),
                                 torch.from_numpy(lens))
        without, _ = tm.prefill(tparams, torch.from_numpy(prompts),
                                tm.init_cache(B, MAX_LEN, s_src))
    assert torch.equal(with_src, without)
    prefill = jax.jit(jm.prefill)
    j_with, _ = prefill(params, jnp.asarray(prompts), jm.init_cache(B, MAX_LEN, s_src),
                        jnp.asarray(src), jnp.asarray(lens))
    j_without, _ = prefill(params, jnp.asarray(prompts), jm.init_cache(B, MAX_LEN, s_src))
    np.testing.assert_array_equal(np.asarray(j_with), np.asarray(j_without))
    assert XATTN_GATE != 0.0
