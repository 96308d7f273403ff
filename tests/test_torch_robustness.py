"""The port's overload control, deadlines, cancel and drain, fault injection
(with the on-device NaN quarantine through ``decode_multi(poison=)``), the
``KeyboardInterrupt`` unwinding and the invariant auditor, each held against
the reference engine on the same trace and plan.

Both engines serve the same reduced llama2-7b (the reference's weights
converted leaf for leaf, ``decode_impl="kernel"``), 2 slots, max_len 64,
chunk 8, decode_ticks 4; the source-KV ingest fault runs on reduced
whisper-small. Every scenario runs the same calls on both engines, with
explicit ``now`` clocks wherever a deadline is involved, and compares each
request's status, code and tokens exactly.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from _torch_parity import JaxEngine, jax_poisson_trace, pair
from repro.serving.trace import chrome_trace as jax_chrome_trace
from repro_torch.serving import (AuditViolation, ContinuousBatchingEngine, EngineAuditor,
                                 FaultPlan, chrome_trace, poisson_trace)

N_REQ = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Side:
    """One engine and its package's serving names."""

    def __init__(self, eng, ns, trace_fn):
        self.eng, self.ns, self._trace_fn = eng, ns, trace_fn

    def trace(self, **kw):
        kw = dict(dict(n_requests=N_REQ, vocab_size=503, prompt_len=(4, 10),
                       max_new=(4, 8), seed=11), **kw)
        return self._trace_fn(**kw)

    def reqs(self, n, *, plen=6, budget=5, **kw):
        rng = np.random.default_rng(7)
        return [self.ns.Request(prompt=rng.integers(0, 503, plen).astype(np.int32),
                                max_new_tokens=budget, rid=i, **kw) for i in range(n)]

    def outcome(self):
        """Every request the scheduler saw: rid -> (status, code, tokens)."""
        return {s.rid: (s.status, s.code, list(s.tokens))
                for s in self.eng.sched.all_states()}


@pytest.fixture(scope="module")
def sides():
    jm, params, tm, tparams = pair("llama2-7b")
    kw = dict(n_slots=2, max_len=64, chunk=8, decode_ticks=4, seed=0)
    ref = JaxEngine(jm, params, telemetry=ref_serving.Telemetry(),
                    overload=ref_serving.OverloadConfig(max_queue=64), **kw).warmup()
    port = ContinuousBatchingEngine(tm, tparams, telemetry=port_serving.Telemetry(),
                                    overload=port_serving.OverloadConfig(max_queue=64),
                                    **kw).warmup()
    return _Side(port, port_serving, poisson_trace), _Side(ref, ref_serving, jax_poisson_trace)


def _report(report):
    return {r["rid"]: (r["status"], r["code"], r["tokens"]) for r in report["requests"]}


def _both(sides, scenario):
    """Run ``scenario(side)`` on the port and on the reference; the port's
    result must equal the reference's. Returns the port's."""
    got, want = (scenario(side) for side in sides)
    assert got == want
    return got


@pytest.fixture(scope="module")
def clean(sides):
    out = _both(sides, lambda s: _report(s.eng.run(s.trace())))
    assert all(status == "retired" for status, _, _ in out.values()) and len(out) == N_REQ
    return {rid: toks for rid, (_, _, toks) in out.items()}


def _with(side, **attrs):
    """Run the side's trace with engine attributes set (faults, auditor),
    then restore them; the report and the attributes used."""
    old = {k: getattr(side.eng, k) for k in attrs}
    for k, v in attrs.items():
        setattr(side.eng, k, v)
    try:
        return side.eng.run(side.trace())
    finally:
        for k, v in old.items():
            setattr(side.eng, k, v)


@pytest.mark.parametrize("policy", ["reject", "shed-oldest", "degrade"])
def test_bounded_queue_policies(sides, policy):
    def scenario(s):
        sched = s.eng.sched
        overload, sched.overload = sched.overload, s.ns.OverloadConfig(max_queue=2,
                                                                       policy=policy)
        try:
            report = s.eng.run(s.trace())
        finally:
            sched.overload = overload
        agg = report["aggregate"]
        return _report(report), agg["n_shed"], agg.get("n_degraded"), s.eng.tel.counts()
    outcome, n_shed, n_degraded, counts = _both(sides, scenario)
    codes = [code for _, code, _ in outcome.values()]
    if policy == "degrade":
        assert n_shed == 0 and n_degraded > 0 and counts["degrade"] == n_degraded
    else:
        assert n_shed > 0 and codes.count("queue_full") == n_shed == counts["shed"]


def test_typed_rejects(sides, clean):
    def scenario(s):
        long = s.ns.Request(prompt=np.zeros(s.eng.pool.capacity + 1, np.int32),
                            max_new_tokens=4, rid="too-long")
        greedy = s.ns.Request(prompt=np.zeros(4, np.int32), max_new_tokens=99, rid="budget")
        report = s.eng.run(s.trace() + [long, greedy])
        return _report(report), report["aggregate"]["n_rejected"]
    outcome, n_rejected = _both(sides, scenario)
    assert n_rejected == 2
    assert outcome["too-long"][:2] == ("rejected", "prompt_too_long")
    assert outcome["budget"][:2] == ("rejected", "budget_too_large")
    assert {rid: toks for rid, (_, _, toks) in outcome.items() if rid in clean} == clean


def test_poison_quarantines_only_its_victim(sides, clean):
    victim = 2

    def scenario(s):
        report = _with(s, faults=s.ns.FaultPlan([s.ns.Fault("poison_nan", rid=victim)]))
        events = s.eng.tel.events
        return (_report(report), report["aggregate"]["n_errored"], s.eng.pool.n_used,
                s.eng.tel.counts(), [(e.kind, e.rid, e.slot, e.block) for e in events])
    outcome, n_errored, n_used, counts, _ = _both(sides, scenario)
    assert outcome[victim][:2] == ("errored", "nonfinite_logits")
    assert outcome[victim][2] == clean[victim][:1]         # its prefill token only
    assert {rid: toks for rid, (_, _, toks) in outcome.items() if rid != victim} == \
        {rid: toks for rid, toks in clean.items() if rid != victim}
    assert (n_errored, n_used, counts["fault"], counts["error_retire"]) == (1, 0, 1, 1)
    port, ref = sides
    assert json.dumps(chrome_trace(port.eng.tel.events)) == \
        json.dumps(jax_chrome_trace(port.eng.tel.events))


def test_poison_none_adds_nothing_and_a_poisoned_row_reads_minus_two(sides):
    """decode_multi on one cache: poison=None and an all-False mask give the
    same block; a poisoned row reports -2 each tick and leaves the others'
    tokens unchanged."""
    eng = sides[0].eng
    model, params = eng.model, eng.params
    cache = model.init_cache(3, 64)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, 503, (3, 6)).astype(np.int32))
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts, cache)
        tok = logits.argmax(-1).to(torch.int32)
        args = (torch.ones(3, dtype=torch.bool), torch.full((3,), 8, dtype=torch.int32),
                torch.arange(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32))
        blocks = {}
        for name, poison in (("none", None), ("off", torch.zeros(3, dtype=torch.bool)),
                             ("row1", torch.tensor([False, True, False]))):
            c = {k: v.clone() for k, v in cache.items()}
            blocks[name], _, emitted, _ = model.decode_multi(params, tok, c, *args, 3,
                                                              poison=poison)
            if name == "row1":
                assert emitted.tolist() == [4, 1, 4]
    assert torch.equal(blocks["none"], blocks["off"])
    assert blocks["row1"][:, 1].tolist() == [-2, -1, -1]
    assert torch.equal(blocks["row1"][:, [0, 2]], blocks["none"][:, [0, 2]])


def test_benign_faults_keep_tokens(sides, clean):
    def scenario(s):
        plan = s.ns.FaultPlan([s.ns.Fault("dispatch_fail", block=1),
                               s.ns.Fault("tick_delay", block=0, delay_s=1e-4)])
        report = _with(s, faults=plan)
        agg = report["aggregate"]
        return (_report(report), agg["faults_fired"], agg["faults_pending"],
                agg["dispatch_retries"], agg["n_errored"], plan.to_json())
    outcome, fired, pending, retries, n_errored, _ = _both(sides, scenario)
    assert {rid: toks for rid, (_, _, toks) in outcome.items()} == clean
    assert (fired, pending, retries, n_errored) == (2, 0, 1, 0)


def test_drain_finishes_in_flight_and_sheds_the_queue(sides):
    def scenario(s):
        s.eng.run([])
        for r in s.trace():
            s.eng.submit(r, now=0.0)
        s.eng.step(now=0.0)
        s.eng.drain()
        late = s.eng.submit(s.ns.Request(prompt=np.zeros(6, np.int32), max_new_tokens=4,
                                         rid="late"), now=0.1)
        for i in range(200):
            if not s.eng.step(now=0.2 + i * 0.01):
                break
        s.eng.sched.assert_conservation()
        return s.outcome(), (late.status, late.code), s.eng.pool.n_used, s.eng.tel.counts()["drain"]
    outcome, late, n_used, n_drain = _both(sides, scenario)
    assert late == ("shed", "drain") and n_used == 0 and n_drain == 1
    assert sum(st == "retired" for st, _, _ in outcome.values()) == 2
    assert sum(c == "drain" for _, c, _ in outcome.values()) == N_REQ - 2 + 1


def test_cancel_queued_and_in_flight(sides):
    def scenario(s):
        s.eng.run([])
        for r in s.trace():
            s.eng.submit(r, now=0.0)
        s.eng.step(now=0.0)
        in_flight = (next(iter(s.eng.sched.decoding.values()), None)
                     or s.eng.sched.prefilling[0])
        queued = s.eng.sched.queue[0]
        for rid in (in_flight.rid, queued.rid, "no-such-rid"):
            s.eng.cancel(rid)
        for i in range(200):
            if not s.eng.step(now=0.1 + i * 0.01):
                break
        s.eng.sched.assert_conservation()
        return s.outcome(), in_flight.rid, queued.rid, s.eng.pool.n_used
    outcome, in_flight, queued, n_used = _both(sides, scenario)
    assert outcome[queued][:2] == ("shed", "cancelled")
    assert outcome[in_flight][:2] == ("retired", "cancelled")
    assert n_used == 0


def test_deadlines_in_queue_and_in_flight(sides):
    def scenario(s):
        s.eng.run([])
        for r in s.reqs(4, budget=40, deadline_s=0.05):
            s.eng.submit(r, now=0.0)
        s.eng.step(now=0.0)                    # 2 in flight, 2 queued
        for i in range(200):                   # past every deadline
            if not s.eng.step(now=1.0 + i * 0.01):
                break
        s.eng.sched.assert_conservation()
        return s.outcome(), s.eng.pool.n_used
    outcome, n_used = _both(sides, scenario)
    assert sorted((st, c) for st, c, _ in outcome.values()) == \
        [("retired", "deadline")] * 2 + [("shed", "deadline")] * 2
    assert n_used == 0


def test_predicted_ttft_gate_and_cold_engine(sides):
    def scenario(s):
        s.eng.run([])
        cold = type(s.eng)(s.eng.model, s.eng.params, n_slots=2, max_len=64, chunk=8)
        cold = cold._predict_ttft(s.ns.Request(prompt=np.zeros(4, np.int32),
                                               max_new_tokens=2, ttft_deadline_s=1e-9))
        svc, chunk = s.eng._svc_s, s.eng._chunk_s
        s.eng._svc_s, s.eng._chunk_s = 5.0, 1.0        # a deeply backlogged engine
        try:
            for r in s.reqs(3):
                s.eng.submit(r, now=0.0)
            s.eng.sched.admit(0.0)
            tight = s.eng.submit(s.ns.Request(prompt=np.zeros(6, np.int32), max_new_tokens=4,
                                              rid="tight", ttft_deadline_s=0.01), now=0.0)
            loose = s.eng.submit(s.ns.Request(prompt=np.zeros(6, np.int32), max_new_tokens=4,
                                              rid="loose", ttft_deadline_s=1e6), now=0.0)
            est = s.eng._predict_ttft(tight.request)
            return cold, (tight.status, tight.code), loose.status, est
        finally:
            s.eng._svc_s, s.eng._chunk_s = svc, chunk
            s.eng.run([])
    cold, tight, loose, est = _both(sides, scenario)
    assert cold is None and tight == ("shed", "ttft_unattainable") and loose == "queued"
    assert est == (2 / 2 + 1) * 5.0 + 1 * 1.0       # two queued waves and one chunk


def test_auditor_clean_run_and_injected_corruption(sides, clean):
    def scenario(s):
        auditor = s.ns.EngineAuditor()
        report = _with(s, auditor=auditor)
        auditor.check(s.eng)                         # a healthy engine
        s.eng.active[0] = True                       # an active row with no owner
        try:
            with pytest.raises(s.ns.AuditViolation) as exc:
                auditor.check(s.eng)
        finally:
            s.eng.active[0] = False
        auditor.check(s.eng)
        return _report(report), report["aggregate"]["audit_checks"], exc.value.invariant
    outcome, checks, invariant = _both(sides, scenario)
    assert {rid: toks for rid, (_, _, toks) in outcome.items()} == clean
    assert checks > 0 and invariant == "active_mask"
    assert issubclass(AuditViolation, AssertionError)


def test_auditor_rate_limit():
    auditor = EngineAuditor(every=4)
    seen = []
    auditor.check = seen.append
    assert [auditor.maybe_check("e") for _ in range(8)] == [False, False, False, True] * 2
    assert len(seen) == 2
    with pytest.raises(ValueError):
        EngineAuditor(every=0)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_chaos_soak_with_replay(sides, clean, seed):
    """A seeded random plan: the same plan in both packages, only its fired
    victims errored, bystanders bitwise the clean run, no slot leaked, and
    ``plan.replay()`` gives the same report."""
    def scenario(s):
        plan = s.ns.FaultPlan.random(seed, list(range(N_REQ)), n_faults=3)
        faulted = _with(s, faults=plan)
        replayed = _with(s, faults=plan.replay())
        assert _report(replayed) == _report(faulted)
        return plan.to_json(), sorted(plan.victims()), _report(faulted), s.eng.pool.n_used
    plan, victims, outcome, n_used = _both(sides, scenario)
    assert n_used == 0
    assert sorted(r for r, (st, _, _) in outcome.items() if st == "errored") == victims
    for rid, (_, _, toks) in outcome.items():
        want = clean[rid][:len(toks)] if rid in victims else clean[rid]
        assert toks == want, (seed, rid)
    assert FaultPlan.random(seed, list(range(N_REQ)), n_faults=3).to_json() == \
        ref_serving.FaultPlan.random(seed, list(range(N_REQ)), n_faults=3).to_json()


def test_keyboard_interrupt_unwinds_into_a_typed_report(sides, clean):
    """A KeyboardInterrupt at the third step: queued requests shed, slot
    holders retire with their partial tokens (code ``interrupt``), the host
    ledgers are empty, the report says ``interrupted``; the engine then
    serves the trace again to the clean tokens."""
    def scenario(s):
        step, calls = s.eng.step, []

        def interrupted_step(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise KeyboardInterrupt
            return step(*a, **kw)
        s.eng.step = interrupted_step
        try:
            report = s.eng.run(s.trace())
        finally:
            del s.eng.step
        agg = report["aggregate"]
        return (_report(report), agg["interrupted"], agg["drained"], s.eng.pool.n_used,
                _report(s.eng.run(s.trace())))
    outcome, interrupted, drained, n_used, again = _both(sides, scenario)
    assert interrupted and drained and n_used == 0
    codes = [c for _, c, _ in outcome.values()]
    assert "interrupt" in codes and set(codes) <= {"interrupt", "max_tokens"}
    assert any(st == "retired" and c == "interrupt" and toks
               for st, c, toks in outcome.values())
    assert any(st == "shed" and c == "interrupt" for st, c, _ in outcome.values())
    assert {rid: toks for rid, (_, _, toks) in again.items()} == clean


def test_ingest_fail_quarantines_before_any_device_write():
    jm, params, tm, tparams = pair("whisper-small")
    kw = dict(n_slots=2, max_len=64, chunk=8, decode_ticks=2, seed=0)
    trace_kw = dict(n_requests=4, vocab_size=jm.cfg.vocab_size, prompt_len=(4, 8),
                    max_new=(3, 5), seed=5, source_len=(2, jm.cfg.source_len),
                    source_dim=jm.cfg.d_model)
    victim = 1
    got = []
    for eng, ns, trace_fn in ((ContinuousBatchingEngine(tm, tparams, **kw), port_serving,
                               poisson_trace),
                              (JaxEngine(jm, params, **kw), ref_serving, jax_poisson_trace)):
        eng.warmup()
        clean = _report(eng.run(trace_fn(**trace_kw)))
        writes = []
        ingest = eng.model.ingest_source if ns is port_serving else None
        if ingest is not None:          # count the port's device writes of sources
            eng.model.ingest_source = lambda *a, **k: (writes.append(a[3]), ingest(*a, **k))[1]
        eng.faults = ns.FaultPlan([ns.Fault("ingest_fail", rid=victim)])
        try:
            report = eng.run(trace_fn(**trace_kw))
        finally:
            eng.faults = None
            if ingest is not None:
                del eng.model.ingest_source
        got.append((clean, _report(report), eng.pool.n_used, eng.src_pool.n_used,
                    report["aggregate"]["source_ingests"], len(writes)))
    (clean, outcome, n_used, n_src, ingests, writes), want = got
    assert (clean, outcome, n_used, n_src, ingests) == want[:5]
    assert outcome[victim] == ("errored", "source_ingest_failed", [])
    assert {r: v for r, v in outcome.items() if r != victim} == \
        {r: v for r, v in clean.items() if r != victim}
    assert (n_used, n_src) == (0, 0) and writes == ingests == 3
