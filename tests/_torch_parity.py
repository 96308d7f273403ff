"""Parity helpers shared by the port's family tests
(``tests/test_torch_families.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_recurrent_models.py``, ``tests/test_torch_xattn_models.py``,
and for the training loss ``tests/test_torch_train_models.py`` and
``tests/test_torch_train_families.py``):
a reduced
config built on both sides from the reference's weights, and the checks of
the lock-step path, the continuous path's model functions and the
continuous engine against the reference, float32, logits and float caches
within 1e-4 absolute, int8 codes, lengths and tokens exactly."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.api import lm_loss as jax_lm_loss
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data.pipeline import batch_for_step, source_for_step
from repro_torch.models.api import build_model, lm_loss, needs_source
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items

ATOL = 1e-4
BATCH, PROMPT, STEPS, MAX_LEN = 3, 12, 10, 64
N_SLOTS, CHUNK = 2, 8

_PAIRS: dict = {}

# The reference inits every cross-attention gate at 0, and a cross term is
# tanh(gate) times the cross read: at init a wrong cross read would still
# match token for token. Cross-attention configs are held at this gate.
XATTN_GATE = 0.5


def with_gates(params: dict, value: float) -> dict:
    """The reference's tree with every cross-attention gate (the ``gate``
    leaves of rank <= 1; a gated MLP's ``gate`` is a matrix) set to
    ``value``."""
    return {k: with_gates(v, value) if isinstance(v, dict)
            else jnp.full_like(v, value) if k == "gate" and v.ndim <= 1 else v
            for k, v in params.items()}


def pair(name: str, decode_impl: str = "kernel"):
    """(reference model, its params, port model, port params) of a reduced
    config on the same weights (the reference's init from PRNGKey(0); on a
    cross-attention config with every gate at XATTN_GATE)."""
    key = (name, decode_impl)
    if key not in _PAIRS:
        jcfg = jax_get_config(name, reduced=True).replace(decode_impl=decode_impl)
        jm = jax_build_model(jcfg)
        params = jm.init_params(jax.random.PRNGKey(0))
        if jcfg.family in ("vlm", "audio"):
            params = with_gates(params, XATTN_GATE)
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


def check_cache(jcache, tcache, what, code_flips=0):
    """Every plane of the port's cache against the reference's: lengths and
    int8 codes exactly, bf16 scale planes exactly, float planes within
    ATOL. With ``code_flips``, up to that many int8 codes may be one step
    off (see ``NEAR_TIES``); they are then set to the reference's, so that
    the next call starts from the reference's state."""
    assert set(tcache) == set(jcache), what
    for key, want in jcache.items():
        want, got = np.asarray(want), tcache[key]
        assert tuple(got.shape) == want.shape, (what, key)
        if got.dtype == torch.int8 and code_flips:
            diff = got.numpy().astype(np.int32) - want
            assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= code_flips, \
                (what, key, np.count_nonzero(diff))
            got.copy_(torch.from_numpy(np.array(want)))
        elif got.dtype == torch.int8 or key == "len":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what}: {key}")
        elif got.dtype == torch.bfloat16:                       # int8 scale planes
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=f"{what}: {key}")


def close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, err_msg=what)


# NEAR_TIES: XLA's CPU code rounds float32 differently from PyTorch's in
# places: it contracts ``a * b + c * d`` into an FMA and sums a row of
# ``rms_norm`` in its own order (``tests/test_torch_recurrent.py`` pins one
# such FMA), so values one float32 rounding apart can fall on either side of
# an int8 rounding boundary. On a +w4a8 config such a flipped activation or
# KV code moves the logits by ~1e-2. Where a check says so, codes may differ
# by one step at a stated count, and greedy tokens are held teacher-forced:
# a token may differ only where the reference's top-2 gap is at most twice
# the row's logit difference there.


def check_near_tie_tokens(name, prompt=PROMPT, max_len=MAX_LEN, steps=STEPS):
    """Greedy lock-step of a +w4a8 config, the port teacher-forced on the
    reference's tokens (see NEAR_TIES): every step's argmax equal to the
    reference's, except at a near-tie."""
    from repro.models.quantized import quantize_params as jax_quantize_params
    from repro_torch.models.quantized import quantize_params
    jm, params, tm, tparams = pair(name)
    qparams, tqparams = jax_quantize_params(params), quantize_params(tparams)
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (BATCH, prompt))
    prompts = prompts.astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(qparams, jnp.asarray(prompts), jm.init_cache(BATCH, max_len))
    with torch.inference_mode():
        tl, tc = tm.prefill(tqparams, torch.from_numpy(prompts), tm.init_cache(BATCH, max_len))
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        want, got = np.asarray(jl, np.float32), tl.numpy()
        diff = np.abs(want - got).max(-1)
        top2 = np.sort(want, -1)[:, -2:]
        differ = want.argmax(-1) != got.argmax(-1)
        assert (top2[:, 1] - top2[:, 0] <= 2 * diff)[differ].all(), (name, step)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = decode(qparams, tok, jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tqparams, torch.from_numpy(np.array(tok)), tc)


def check_lockstep(name, prompt=PROMPT, max_len=MAX_LEN, near_ties=False, code_flips=0):
    """Logits and caches of a prefill and two decode steps, then greedy
    ``generate`` tokens, against the reference's (with ``near_ties``, the
    tokens by :func:`check_near_tie_tokens`). ``code_flips``: int8 cache
    codes allowed one step off at each cache comparison (NEAR_TIES)."""
    jm, params, tm, tparams = pair(name)
    check = functools.partial(check_cache, code_flips=code_flips)
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (BATCH, prompt))
    prompts = prompts.astype(np.int32)
    jc, tc = jm.init_cache(BATCH, max_len), tm.init_cache(BATCH, max_len)
    check_cache(jc, tc, "init_cache")
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jc)
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, torch.from_numpy(prompts), tc)
    close(tl, jl, "prefill logits")
    check(jc, tc, "prefill")
    decode = jax.jit(jm.decode_step)
    for step in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = decode(params, tok, jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, torch.from_numpy(np.asarray(tok)), tc)
        close(tl, jl, f"decode step {step} logits")
        check(jc, tc, f"decode step {step}")
    if near_ties:
        check_near_tie_tokens(name, prompt, max_len)
        return
    want = JaxServingEngine(jm, params, max_len=max_len, batch=BATCH).generate(
        jnp.asarray(prompts), steps=STEPS)
    got = ServingEngine(tm, tparams, max_len=max_len, batch=BATCH).generate(
        torch.from_numpy(prompts), steps=STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_ragged(name, prompt_len=20, max_len=MAX_LEN, code_flips=0):
    """The continuous path's model functions on both sides: the chunks of a
    ``prompt_len``-token prompt in one slot (the last one padded), one
    batched advance with an invalid row, two commits, a ragged step with a
    parked row, a K = 4 block with a mid-block EOS, a release.
    ``code_flips``: int8 cache codes allowed one step off (NEAR_TIES)."""
    jm, params, tm, tparams = pair(name)
    check = functools.partial(check_cache, code_flips=code_flips)
    vocab, n = jm.cfg.vocab_size, 3
    rng = np.random.default_rng(11)
    jc, tc = jm.init_cache(n, max_len, chunk=CHUNK), tm.init_cache(n, max_len, chunk=CHUNK)
    prompt = rng.integers(0, vocab, prompt_len).astype(np.int32)
    chunk_fn = jax.jit(jm.prefill_chunk)
    for off in range(0, prompt_len, CHUNK):
        part = np.zeros(CHUNK, np.int32)
        part[:min(CHUNK, prompt_len - off)] = prompt[off:off + CHUNK]
        last = min(CHUNK - 1, prompt_len - 1 - off)
        jl, jc = chunk_fn(params, jnp.asarray(part), jc, jnp.int32(1), jnp.int32(off),
                          jnp.int32(last))
        with torch.inference_mode():
            tl, tc = tm.prefill_chunk(tparams, torch.from_numpy(part), tc, 1, off, last)
        close(tl, jl, f"prefill_chunk logits at offset {off}")
        check(jc, tc, f"prefill_chunk at offset {off}")

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
    check(jc, tc, "prefill_chunks_batched")
    jc = jax.jit(jm.finalize_slot)(jax.jit(jm.finalize_slot)(jc, jnp.int32(1),
                                                             jnp.int32(prompt_len)),
                                   jnp.int32(0), jnp.int32(6))
    tc = tm.finalize_slot(tm.finalize_slot(tc, 1, prompt_len), 0, 6)
    check(jc, tc, "finalize_slot")

    tok, active = np.array([3, 7, 11], np.int32), np.array([True, True, False])
    jl, jc = jax.jit(jm.decode_step)(params, jnp.asarray(tok), jc, jnp.asarray(active))
    with torch.inference_mode():
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc, torch.from_numpy(active))
    close(tl, jl, "decode_step(active=) logits")
    check(jc, tc, "decode_step(active=)")

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
    check(jc, tc, "decode_multi")
    jc = jax.jit(jm.release_slot)(jc, jnp.int32(1))
    check(jc, tm.release_slot(tc, 1), "release_slot")


def check_engine(name, ticks, prompt_len=(3, 18), max_len=MAX_LEN, n_requests=4,
                 decode_impl="kernel", **trace_kw):
    """Greedy tokens of the port's engine equal the reference engine's on
    the conformance trace (4 requests, 2 slots, max_len 64, chunk 8; or the
    prompt lengths, max_len, count and further ``poisson_trace`` arguments
    given: sources), both models on ``decode_impl``. Returns both reports'
    aggregates (port, reference)."""
    jm, params, tm, tparams = pair(name, decode_impl)
    kw = dict(n_requests=n_requests, vocab_size=jm.cfg.vocab_size, prompt_len=prompt_len,
              max_new=(3, 12), seed=5, **trace_kw)
    want = JaxEngine(jm, params, n_slots=N_SLOTS, max_len=max_len, chunk=CHUNK,
                     decode_ticks=ticks).run(jax_poisson_trace(**kw))
    got = ContinuousBatchingEngine(tm, tparams, n_slots=N_SLOTS, max_len=max_len,
                                   chunk=CHUNK, decode_ticks=ticks).run(poisson_trace(**kw))
    tokens = lambda report: {r["rid"]: r["tokens"] for r in report["requests"]}
    assert tokens(got) == tokens(want)
    assert got["aggregate"]["n_retired"] == n_requests
    return got["aggregate"], want["aggregate"]


# ---- training: lm_loss and its gradients (tests/test_torch_train_*.py) ----
# The loss within LOSS_RTOL relative; each gradient leaf within GRAD_RTOL of
# that leaf's largest reference gradient.
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def counted_batch(cfg, b: int = 2, s: int = 16, step: int = 0) -> dict:
    """The counted batch of seed 0 at ``step`` (with its sources on a
    cross-attention config), as the training loop makes it."""
    out = batch_for_step(cfg.vocab_size, s, b, 0, step)
    if needs_source(cfg):
        out["source"] = source_for_step(cfg, b, 0, step)
    return out


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(name: str):
    """The reference's jitted ``value_and_grad`` of ``lm_loss`` (no remat)
    on the reduced config ``name``."""
    jm = pair(name)[0]

    def loss(params, batch):
        return jax_lm_loss(jm, params, batch["tokens"], batch["labels"], batch.get("source"),
                           remat=False)
    return jax.jit(jax.value_and_grad(loss))


def check_loss_and_grads(name: str, batch: dict, remat: bool = True) -> dict:
    """The port's loss and every gradient leaf against the reference's;
    returns the port's gradients by path."""
    jm, params, tm, tparams = pair(name)
    want_loss, want_grads = jax_value_and_grad(name)(params, jax_batch(batch))
    loss, grads = _value_and_grad(
        lambda p, b: lm_loss(tm, p, b["tokens"], b["labels"], b.get("source"), remat=remat),
        tparams, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL, err_msg=name)
    got = dict(tree_items(grads))
    want = dict(tree_items(jax.tree.map(np.asarray, want_grads)))
    assert set(got) == set(want), name
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (name, path)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, (name, path, err, scale)
    return got
