"""Chrome/Perfetto trace-event export of the serving telemetry stream. Port
of ``repro.serving.trace``: for the same event list the JSON is the
reference's, byte for byte.

Converts :class:`repro_torch.serving.telemetry.Event` streams (or their
JSONL dicts) into the Chrome trace-event JSON format (the ``traceEvents``
array form), loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

* **one timeline lane per slot**: slot ``s`` maps to tid ``s + 1`` (stable
  for the whole trace); slot-bound events (``prefill_chunk``,
  ``decode_block`` slices, ``first_token``, retirements) land on their
  slot's lane, so a lane reads as the life of that slot;
* **a scheduler lane** (tid 0) for pre-slot events (``enqueue``,
  ``reject``, ``shed``, ``degrade``, ``drain``, slotless ``fault``
  injections) and the source-KV pool ledger's events (keyed by entry, not
  slot); slot-bound robustness events (``abort``, ``error_retire``,
  slot-targeted ``fault``) land on the slot's lane, so a quarantine reads
  in place: the decode-block slice, the fault mark, then ``error_retire``;
* **counter tracks** for the per-block gauges (queue depth, occupancy, free
  slots, live KV bytes, tick horizon K, parked ticks).

Timestamps: events carry engine-clock seconds; the export writes
microseconds. A ``decode_block`` slice spans dispatch to host sync (real
blocking time); a ``prefill_chunk`` slice spans the host's dispatch call
only (the kernels retire asynchronously).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

PID = 1                      # single engine process
SCHED_TID = 0                # scheduler / pool-ledger lane


def slot_tid(slot: int) -> int:
    """Stable lane id for a slot: tid = slot + 1 (tid 0 is the scheduler)."""
    return int(slot) + 1


def _field(ev, name, default=None):
    """Events may be dataclasses (live stream) or dicts (JSONL reload)."""
    if isinstance(ev, dict):
        return ev.get(name, default)
    return getattr(ev, name, default)


def _us(t: float) -> float:
    return round(float(t) * 1e6, 3)


def _args(ev, **extra) -> dict:
    args = {}
    for k in ("rid", "serial", "block"):
        v = _field(ev, k)
        if v is not None:
            args[k] = v
    data = _field(ev, "data") or {}
    args.update({k: v for k, v in data.items() if k not in extra})
    args.update(extra)
    return args


def chrome_trace(events: Iterable, *, engine_name: str = "serving-engine",
                 ) -> dict:
    """Build the Chrome trace-event dict for an event stream. Deterministic:
    the same stream produces the same JSON, and a slot's tid never changes.
    ``otherData.generator`` names the format both packages write, so a
    viewer reads the two exports alike."""
    out: list[dict] = []
    tids: set[int] = {SCHED_TID}

    def lane(ev) -> int:
        slot = _field(ev, "slot")
        tid = SCHED_TID if slot is None else slot_tid(slot)
        tids.add(tid)
        return tid

    for ev in events:
        kind = _field(ev, "kind")
        t = float(_field(ev, "t"))
        data = _field(ev, "data") or {}
        if kind == "gauges":
            for name, val in data.items():
                if isinstance(val, (int, float)):
                    out.append({"name": name, "ph": "C", "ts": _us(t),
                                "pid": PID, "args": {name: val}})
            continue
        if kind == "decode_block":
            dur = float(data.get("dur", 0.0))
            slots = data.get("slots", [])
            serials = data.get("serials", [None] * len(slots))
            toks = data.get("tokens_per_slot", [None] * len(slots))
            for s, serial, n in zip(slots, serials, toks):
                tids.add(slot_tid(s))
                out.append({
                    "name": f"decode_block k={data.get('k')}",
                    "ph": "X", "ts": _us(t - dur), "dur": _us(dur),
                    "pid": PID, "tid": slot_tid(s),
                    "args": {"rid": None, "serial": serial,
                             "block": _field(ev, "block"),
                             "k": data.get("k"), "tokens": n,
                             "parked_block": data.get("parked")}})
            continue
        if kind == "prefill_chunk":
            dur = float(data.get("dur", 0.0))
            out.append({
                "name": "prefill_chunk", "ph": "X",
                "ts": _us(t - dur), "dur": _us(dur),
                "pid": PID, "tid": lane(ev),
                "args": _args(ev)})
            continue
        # everything else: an instant mark on its lane
        out.append({"name": kind, "ph": "i", "ts": _us(t), "pid": PID,
                    "tid": lane(ev), "s": "t", "args": _args(ev)})

    meta = [{"name": "process_name", "ph": "M", "pid": PID,
             "args": {"name": engine_name}}]
    for tid in sorted(tids):
        name = "scheduler" if tid == SCHED_TID else f"slot {tid - 1}"
        meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                     "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"generator": "repro.serving.trace"}}


def write_chrome_trace(events: Iterable, path: str | Path, **kw) -> Path:
    path = Path(path)
    path.write_text(json.dumps(chrome_trace(events, **kw)))
    return path
