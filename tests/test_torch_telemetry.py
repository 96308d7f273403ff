"""The port's serving telemetry against the reference's: the event stream of
``repro_torch.serving.Telemetry``, its JSONL sink, the Chrome/Perfetto
export of ``repro_torch.serving.trace``, the source-KV pool's ledger events,
and ``launch/serve.py``'s trace flags.

Both engines serve the same reduced llama2-7b (the reference's weights
converted leaf for leaf, ``decode_impl="kernel"``: the port runs its
kernels' plain versions on the CPU, the reference its Pallas kernels in
interpret mode) over the same backlogged trace. Their event streams must
be equal apart from the wall-clock fields (``t``, ``dur``, ``queued_s``),
and for one event list the two exports' JSON must be equal byte for byte.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import JaxEngine, jax_poisson_trace, pair
from repro.serving import SourceKVPool as JaxSourceKVPool
from repro.serving import Telemetry as JaxTelemetry
from repro.serving.trace import chrome_trace as jax_chrome_trace
from repro_torch.serving import (ContinuousBatchingEngine, SourceKVPool, Telemetry,
                                 chrome_trace, load_events_jsonl, poisson_trace,
                                 write_chrome_trace)
from repro_torch.serving.telemetry import EVENT_KINDS, LIFECYCLE_KINDS
from repro_torch.serving.trace import PID, SCHED_TID, slot_tid

ROOT = Path(__file__).resolve().parent.parent
TIMED = ("dur", "queued_s")             # data fields read off the wall clock
N_REQ, N_SLOTS = 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace(port: bool):
    kw = dict(n_requests=N_REQ, vocab_size=503, prompt_len=(4, 24), max_new=(4, 20),
              seed=3)
    return poisson_trace(**kw) if port else jax_poisson_trace(**kw)


def _stream(events):
    return [(e.kind, e.rid, e.slot, e.serial, e.block,
             {k: v for k, v in e.data.items() if k not in TIMED}) for e in events]


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report["requests"]}


@pytest.fixture(scope="module")
def runs():
    """One traced run of each engine (decode_ticks 4, 3 slots) and one
    untraced run of the port's, on the same trace."""
    jm, params, tm, tparams = pair("llama2-7b")
    kw = dict(n_slots=N_SLOTS, max_len=64, chunk=8, decode_ticks=4, seed=0)
    jtel, tel = JaxTelemetry(), Telemetry()
    want = JaxEngine(jm, params, telemetry=jtel, **kw).warmup().run(_trace(False))
    got = ContinuousBatchingEngine(tm, tparams, telemetry=tel, **kw).warmup().run(_trace(True))
    bare = ContinuousBatchingEngine(tm, tparams, **kw).warmup().run(_trace(True))
    return dict(jtel=jtel, tel=tel, want=want, got=got, bare=bare)


def test_event_stream_equals_reference_apart_from_times(runs):
    assert _tokens(runs["got"]) == _tokens(runs["want"])
    assert _stream(runs["tel"].events) == _stream(runs["jtel"].events)
    assert runs["tel"].counts() == runs["jtel"].counts()


def test_telemetry_off_identical_tokens_and_no_events(runs):
    got, bare = runs["got"], runs["bare"]
    assert _tokens(bare) == _tokens(got)
    assert "telemetry_events" not in bare["aggregate"]
    assert got["aggregate"]["telemetry_events"] == len(runs["tel"].events) > 0
    keys = ("decode_dispatches", "decode_ticks_run", "prefill_dispatches",
            "dispatches", "host_syncs", "issued_ticks", "parked_ticks")
    assert {k: bare["aggregate"][k] for k in keys} == {k: got["aggregate"][k] for k in keys}


def test_event_counts_match_report_counters(runs):
    tel, agg = runs["tel"], runs["got"]["aggregate"]
    counts, n = tel.counts(), agg["n_retired"]
    assert agg["n_requests"] == N_REQ == n and agg["n_rejected"] == 0
    assert counts["enqueue"] == counts["admit"] == counts["first_token"] == n
    assert counts["release"] == counts["eos"] + counts["budget_retire"] == n
    assert counts["decode_block"] == counts["gauges"] == agg["decode_dispatches"]
    assert counts["prefill_chunk"] == agg["prefill_chunks"]
    assert counts["backfill"] >= n - N_SLOTS
    blocks = tel.by_kind("decode_block")
    assert sum(b.data["k"] * len(b.data["slots"]) for b in blocks) == agg["issued_ticks"]
    assert sum(b.data["parked"] for b in blocks) == agg["parked_ticks"]
    assert sum(b.data["emitted"] for b in blocks) + n == agg["generated_tokens"]
    for rid in _tokens(runs["got"]):
        kinds = [e.kind for e in tel.by_rid(rid)]
        order = [k for k in kinds if k in ("enqueue", "admit", "first_token", "release")]
        assert order == ["enqueue", "admit", "first_token", "release"], rid


@pytest.mark.parametrize("source", ["reference", "port", "jsonl"])
def test_chrome_trace_json_equals_reference(runs, source, tmp_path):
    """One event list, both exporters: the same JSON. The list is the
    reference's stream, the port's, or the port's reloaded from JSONL."""
    if source == "reference":
        events = runs["jtel"].events
    elif source == "port":
        events = runs["tel"].events
    else:
        path = tmp_path / "events.jsonl"
        with Telemetry(jsonl_path=path) as tel:
            for e in runs["tel"].events:
                tel.emit(e.kind, t=e.t, rid=e.rid, slot=e.slot, serial=e.serial,
                         block=e.block, **e.data)
        events = load_events_jsonl(path)
    got = json.dumps(chrome_trace(events, engine_name="e"))
    assert got == json.dumps(jax_chrome_trace(events, engine_name="e"))
    doc = json.loads(got)
    assert all(e["pid"] == PID for e in doc["traceEvents"])
    lanes = {(e["tid"], e["args"]["name"]) for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {(SCHED_TID, "scheduler")} | {(slot_tid(s), f"slot {s}")
                                         for s in range(N_SLOTS)} <= lanes
    path = write_chrome_trace(events, tmp_path / "run.trace.json", engine_name="e")
    assert path.read_text() == got


def test_jsonl_roundtrip_and_reset(tmp_path):
    path = tmp_path / "events.jsonl"
    with Telemetry(jsonl_path=path) as tel:
        tel.emit("enqueue", t=0.25, rid="r0", queue_depth=1)
        tel.emit("admit", t=0.5, rid="r0", slot=2, serial=3)
        tel.emit("gauges", t=1.0, block=0, occupancy=0.5)
        with pytest.raises(ValueError):
            tel.emit("made_up_kind", t=0.0)
        tel.flush()
        back = load_events_jsonl(path)
        assert [e.kind for e in back] == ["enqueue", "admit", "gauges"]
        assert (back[1].slot, back[1].serial) == (2, 3)
        assert back[0].data == {"queue_depth": 1} and back[2].data == {"occupancy": 0.5}
        assert [e.to_json() for e in back] == [e.to_json() for e in tel.events]
        tel.reset()
        assert path.read_text() == "" and tel.events == []
    assert set(LIFECYCLE_KINDS) < EVENT_KINDS and "gauges" in EVENT_KINDS


def test_source_pool_ledger_events_match_reference():
    """The same acquire/release calls give the same ledger events and the
    same queries on both pools."""
    seen = {"port": [], "ref": []}
    pools = {"port": SourceKVPool(2, src_max=8, on_event=lambda k, **d: seen["port"].append((k, d))),
             "ref": JaxSourceKVPool(2, src_max=8, on_event=lambda k, **d: seen["ref"].append((k, d)))}
    for name, pool in pools.items():
        e0, fresh = pool.acquire("A", owner="r0")
        assert fresh and pool.entry_of("A") == e0 and pool.fits(8) and not pool.fits(9)
        assert pool.acquire("A", owner="r1") == (e0, False)
        pool.acquire("B", owner="r2")
        assert pool.total_refs() == 3
        assert pool.release("A", owner="r0") is None
        assert pool.release("A", owner="r1") == e0
        pool.release("B", owner="r2")
        assert pool.total_refs() == 0 and pool.n_used == 0
        pool.assert_consistent()
    assert seen["port"] == seen["ref"]
    assert [k for k, _ in seen["port"]] == ["source_ingest", "source_share", "source_ingest",
                                           "source_release", "source_release"]
    silent = SourceKVPool(1, src_max=4)
    assert silent.acquire("s", owner="r") == (0, True) and silent.release("s") == 0


def test_serve_cli_writes_valid_trace_files(tmp_path):
    """``serve.py --continuous --reduced --device cpu`` with the serving
    extras' flags: a Chrome trace and a JSONL stream that the port's viewer
    converts to the same trace up to the JSONL's rounding of ``t``."""
    from repro_torch.launch import serve
    trace_out, events_out = tmp_path / "run.trace.json", tmp_path / "run.events.jsonl"
    report, metrics = serve.main([
        "--arch", "llama2-7b", "--reduced", "--device", "cpu", "--continuous",
        "--requests", "6", "--n-slots", "2", "--max-len", "64", "--chunk", "8",
        "--gen", "8", "--prompt-len", "12", "--decode-ticks", "4",
        "--trace-shape", "bursty", "--max-queue", "2", "--shed-policy", "shed-oldest",
        "--audit", "--trace-out", str(trace_out), "--events-out", str(events_out)])
    assert metrics["audit_checks"] > 0 and metrics["telemetry_events"] > 0
    assert metrics["n_shed"] + metrics["n_retired"] == 6
    doc = json.loads(trace_out.read_text())
    events = load_events_jsonl(events_out)
    assert len(events) == metrics["telemetry_events"]
    assert sum(e.kind == "shed" for e in events) == metrics["n_shed"]
    assert len(doc["traceEvents"]) == len(chrome_trace(events)["traceEvents"])
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_trace_viewer
    finally:
        sys.path.remove(str(ROOT / "tools"))
    out = tmp_path / "viewer.trace.json"
    assert torch_trace_viewer.main([str(events_out), str(out)]) == 0
    assert json.loads(out.read_text()) == chrome_trace(events)
    np.testing.assert_allclose(
        [e["ts"] for e in json.loads(out.read_text())["traceEvents"] if "ts" in e],
        [e["ts"] for e in doc["traceEvents"] if "ts" in e], atol=1.0)
