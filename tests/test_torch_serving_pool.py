"""The port's numpy-only serving ledgers and its counter-based sampler
against the reference: ``KVSlotPool`` / ``Scheduler`` cases mirroring the
reference's own (``tests/test_serving_continuous.py``), ``poisson_trace``
byte for byte, ``LogHistogram`` percentiles, and the Threefry key
derivation: raw bits equal to ``jax.random.bits`` bitwise, Gumbel draws
within 1e-6 (both sides take ``-log(-log(u))`` of the same ``u``; their
``log`` implementations may round the last bit differently)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import seeded_gumbel_pick as jax_seeded_gumbel_pick
from repro.serving import LogHistogram as JaxLogHistogram
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.core import prng
from repro_torch.serving import (KVSlotPool, LogHistogram, Request, Scheduler,
                                 SlotPoolError, poisson_trace)
from repro_torch.serving.workload import load_trace

# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------


def test_slot_pool_alloc_release_reuse():
    pool = KVSlotPool(3, max_len=64)
    assert pool.capacity == 63 and pool.n_free == 3       # the tail row parks
    a, b, c = pool.alloc("r0"), pool.alloc("r1"), pool.alloc("r2")
    assert sorted([a, b, c]) == [0, 1, 2]
    assert pool.alloc("r3") is None                       # exhausted
    pool.set_length(b, 17)
    assert pool.length(b) == 17 and pool.occupancy() == 1.0
    assert pool.release(b) == "r1"
    assert pool.length(b) == 0                            # reset-on-release
    assert pool.alloc("r3") == b                          # freed slot reused
    pool.assert_consistent()


def test_slot_pool_misuse_raises():
    pool = KVSlotPool(2, max_len=32)
    s = pool.alloc("r0")
    pool.release(s)
    with pytest.raises(SlotPoolError):
        pool.release(s)                                   # double release
    with pytest.raises(SlotPoolError):
        pool.set_length(s, 4)                             # unowned slot
    s = pool.alloc("r1")
    with pytest.raises(SlotPoolError):
        pool.set_length(s, pool.capacity + 1)             # over capacity
    assert not pool.fits(pool.capacity + 1) and pool.fits(pool.capacity)
    with pytest.raises(SlotPoolError):
        KVSlotPool(0, max_len=8)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _req(rid, p=4, gen=3):
    return Request(prompt=np.arange(p, dtype=np.int32), max_new_tokens=gen, rid=rid)


def test_scheduler_conservation_and_backfill():
    sched = Scheduler(KVSlotPool(2, max_len=64))
    for i in range(5):
        sched.submit(_req(i))
    rej = sched.submit(Request(prompt=np.zeros(60, np.int32), max_new_tokens=10,
                               rid="big"))
    assert rej.status == "rejected" and rej.code == "budget_too_large"
    retired, now = [], 0.0
    while sched.pending():
        sched.admit(now)
        assert sched.pool.n_used <= 2
        for st in list(sched.prefilling):
            st.prefilled = len(st.request.prompt)
            sched.start_decoding(st)
        _, st = next(iter(sched.decoding.items()))         # retire one per tick
        sched.retire(st, "max_tokens", now)
        retired.append(st.rid)
        sched.assert_conservation()
        now += 1.0
    assert sorted(retired) == [0, 1, 2, 3, 4]
    assert sched.n_admitted == sched.n_retired == 5 and sched.pool.n_free == 2


def test_scheduler_fifo_admission_and_duplicate_rids():
    sched = Scheduler(KVSlotPool(1, max_len=64))
    for i in range(3):
        sched.submit(_req(i))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(_req(1))
    order = []
    while sched.pending():
        sched.admit(0.0)
        for st in list(sched.prefilling):
            st.prefilled = len(st.request.prompt)
            sched.start_decoding(st)
            order.append(st.rid)
        _, st = next(iter(sched.decoding.items()))
        sched.retire(st, "max_tokens", 0.0)
    assert order == [0, 1, 2]


def test_request_validation():
    with pytest.raises(ValueError):
        Request(prompt=np.zeros(0, np.int32), max_new_tokens=1)
    with pytest.raises(ValueError):
        Request(prompt=np.zeros(3, np.int32), max_new_tokens=0)
    assert Request(prompt=[1, 2, 3], max_new_tokens=4).budget == 6


# ---------------------------------------------------------------------------
# trace harness and histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 9])
def test_poisson_trace_equals_the_reference(seed):
    for kw in ({}, {"rate": 20.0}, {"rate": 20.0, "shape": "bursty"},
               {"rate": 5.0, "shape": "heavy-tail"}):
        want = jax_poisson_trace(n_requests=6, vocab_size=503, seed=seed, **kw)
        got = poisson_trace(n_requests=6, vocab_size=503, seed=seed, **kw)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert g.prompt.tobytes() == w.prompt.tobytes()
            assert (g.max_new_tokens, g.rid, g.arrival) == (w.max_new_tokens, w.rid,
                                                            w.arrival)


def test_load_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text('[{"prompt_len": 5, "max_new_tokens": 3, "arrival": 0.5},'
                    ' {"prompt": [1, 700, 3], "max_new_tokens": 2, "rid": "x"}]')
    a, b = load_trace(path, vocab_size=503)
    assert a.prompt.shape == (5,) and a.arrival == 0.5 and a.rid == 0
    assert b.prompt.tolist() == [1, 700 % 503, 3] and b.rid == "x"


def test_log_histogram_matches_the_reference():
    xs = np.random.default_rng(4).lognormal(-4.0, 1.5, 500)
    got, want = LogHistogram(), JaxLogHistogram()
    for x in xs:
        got.add(float(x))
        want.add(float(x))
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert got.percentile(q) == want.percentile(q)
    assert LogHistogram().percentile(0.5) is None
    both = LogHistogram().merge(got).merge(got)
    assert both.n == 1000 and both.percentile(0.5) == got.percentile(0.5)


# ---------------------------------------------------------------------------
# counter-based sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_threefry_bits_equal_jax_random_bits(seed):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
    for serial, idx in ((0, 0), (5, 7), (2 ** 31 - 1, 123), (2 ** 32 - 1, 1)):
        jk = jax.random.fold_in(jax.random.fold_in(jkey, serial), idx)
        tk = prng.fold_in(prng.fold_in(tkey, serial), idx)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        for shape in ((503,), (3, 7)):
            np.testing.assert_array_equal(
                prng.random_bits(tk, shape).numpy(),
                np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        np.testing.assert_allclose(prng.gumbel(tk, (503,)).numpy(),
                                   np.asarray(jax.random.gumbel(jk, (503,))),
                                   rtol=0, atol=1e-6)


def test_seeded_gumbel_pick_batched_equals_the_reference_per_row():
    """Rows fold in their own (serial, token index): the batched pick
    equals the reference's pick row by row."""
    logits = np.random.default_rng(2).standard_normal((4, 503)).astype(np.float32)
    serials = np.array([0, 1, 9, 1], np.int32)
    idx = np.array([0, 3, 2, 4], np.int32)
    got = prng.seeded_gumbel_pick(prng.prng_key(3), torch.from_numpy(logits),
                                  torch.from_numpy(serials), torch.from_numpy(idx), 0.8)
    want = [int(jax_seeded_gumbel_pick(jax.random.PRNGKey(3), jnp.asarray(row), s, i, 0.8))
            for row, s, i in zip(logits, serials, idx)]
    assert got.dtype == torch.int32 and got.tolist() == want
    one = prng.seeded_gumbel_pick(prng.prng_key(3), torch.from_numpy(logits[2]), 9, 2, 0.8)
    assert one.shape == () and int(one) == want[2]
