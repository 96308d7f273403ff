"""Serving telemetry of the port: structured lifecycle events, per-block
engine gauges, and mergeable log-bucket latency histograms. Port of
``repro.serving.telemetry`` (numpy-free: the standard library only), name
for name, so that both engines emit the same event stream for a trace.

``report()`` says *what* happened; the event stream says *where the time
went*: every request emits typed lifecycle events stamped in seconds on the
engine clock (relative to the run's ``t0``), every decode block samples the
engine's gauges (occupancy, queue depth, free slots, live KV bytes, the
tick horizon K, parked ticks), and the stream converts to the Chrome /
Perfetto trace-event format (:mod:`repro_torch.serving.trace`).

* **Zero overhead when disabled.** The engine holds ``telemetry=None`` by
  default and every emission site is one falsy check, so the disabled path
  is the host loop without telemetry: the same tokens, no event objects.
* **Events are host-side only.** An event records what the host already
  knew at a dispatch or sync site; nothing here touches the device, so
  enabling telemetry cannot change a kernel launch or a token.

Event taxonomy:

======================  =====================================================
kind                    emitted when
======================  =====================================================
``enqueue``             request accepted into the FIFO queue (scheduler)
``reject``              request refused at submit (capacity / source rules)
``admit``               queued request allocated a slot (scheduler)
``backfill``            the admit reused a slot freed earlier this run
``source_ingest``       source-KV pool entry freshly acquired (pool ledger)
``source_share``        acquisition served by refcount on a resident entry
``source_release``      last holder retired; entry handed back for zeroing
``prefill_chunk``       a slot advanced one prompt chunk (per slot, per
                        batched dispatch)
``first_token``         final chunk landed; token 0 sampled off the prefill
                        logits
``decode_block``        one K-tick fused decode dispatch + its host sync
``eos``                 request retired by sampling ``eos_id``
``budget_retire``       request retired by exhausting ``max_new_tokens``
``release``             slot's device state reset after retirement
``shed``                overload control dropped a request (queue full,
                        deadline expired in queue, cancel, drain) — carries
                        the typed ``code``
``degrade``             bounded-queue degrade policy shrank a queued
                        request's ``max_new_tokens``
``abort``               slot-holding request stopped early (deadline /
                        cancel / drain / interrupt) with partial tokens
``error_retire``        slot-holding request quarantined with a typed error
                        (non-finite logits, failed source ingest)
``fault``               an injected fault fired (``serving.faults``)
``drain``               engine entered graceful-shutdown drain mode
``gauges``              engine gauges sampled at a decode block's sync
======================  =====================================================

Every event carries ``t`` (engine-clock seconds) and, where meaningful,
``rid`` (request id), ``slot``, ``serial`` (admission serial) and ``block``
(decode/prefill dispatch index); kind-specific fields ride in ``data``.
"""
from __future__ import annotations

import json
import math
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO

LIFECYCLE_KINDS = (
    "enqueue", "reject", "admit", "backfill",
    "source_ingest", "source_share", "source_release",
    "prefill_chunk", "first_token", "decode_block",
    "eos", "budget_retire", "release",
    "shed", "degrade", "abort", "error_retire", "fault", "drain",
)
EVENT_KINDS = frozenset(LIFECYCLE_KINDS) | {"gauges"}


@dataclass(slots=True)
class Event:
    """One telemetry event. ``t`` is seconds on the engine clock (monotonic,
    relative to the run's ``t0`` — the same clock ``report()`` timestamps
    use). ``data`` holds the kind-specific payload (chunk offsets, tick
    horizon, gauge values, ...)."""
    kind: str
    t: float
    rid: object = None
    slot: int | None = None
    serial: int | None = None
    block: int | None = None
    data: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"kind": self.kind, "t": round(self.t, 6)}
        for k in ("rid", "slot", "serial", "block"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.data:
            out["data"] = self.data
        return out


class LogHistogram:
    """Fixed-size log-bucket histogram for streaming latency percentiles.

    Bucket ``i`` covers ``[lo * g**i, lo * g**(i+1))`` with
    ``g = 10 ** (1 / buckets_per_decade)``; values below ``lo`` land in
    bucket 0, values at or above ``hi`` in the last bucket. Insert is O(1)
    and the memory is a fixed int list, so per-token ITL accounting stays
    bounded on arbitrarily long traces.

    ``percentile(q)`` returns the geometric midpoint of the bucket holding
    the nearest-rank sample — within one bucket (a factor of ``g``) of the
    exact nearest-rank value.

    Histograms with identical bounds **merge** by adding counts
    (:meth:`merge`), so per-engine or per-run histograms aggregate exactly.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 16):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo, self.hi = float(lo), float(hi)
        self.bpd = buckets_per_decade
        self._log_g = math.log(10.0) / buckets_per_decade
        self.n_buckets = (int(math.ceil(
            (math.log(hi) - math.log(lo)) / self._log_g)) + 1)
        self.counts = [0] * self.n_buckets
        self.n = 0

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int((math.log(x) - math.log(self.lo)) / self._log_g)
        return min(i, self.n_buckets - 1)

    def add(self, x: float) -> None:
        self.counts[self._bucket(x)] += 1
        self.n += 1

    def edges(self, i: int) -> tuple[float, float]:
        lo = self.lo * math.exp(i * self._log_g)
        return lo, lo * math.exp(self._log_g)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile (the sample at index ``ceil(q*n) - 1``
        of the sorted stream), returned as the geometric midpoint of its
        bucket. None on an empty histogram."""
        if not self.n:
            return None
        rank = max(0, math.ceil(q * self.n) - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                a, b = self.edges(i)
                return math.sqrt(a * b)
        return self.edges(self.n_buckets - 1)[1]       # unreachable

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        if (self.lo, self.hi, self.bpd) != (other.lo, other.hi, other.bpd):
            raise ValueError("histogram bounds differ; cannot merge")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        return self

    def reset(self) -> None:
        self.counts = [0] * self.n_buckets
        self.n = 0


class Telemetry:
    """Event sink + gauge recorder for one engine.

    Pass an instance to ``ContinuousBatchingEngine(telemetry=...)``; the
    engine (and, through its ``on_event`` sinks, the scheduler and the
    source-KV pool ledgers) emit into it. ``run()`` resets the sink at
    entry — mirroring ``reset_stats`` — so after a run the stream covers
    exactly that run's traffic (warmup events are dropped).

    ``jsonl_path``: stream every event as one JSON line (truncated at each
    reset, so the file matches the in-memory stream). Convert with
    ``tools/torch_trace_viewer.py`` or export directly via
    :meth:`write_chrome_trace`.
    """

    def __init__(self, jsonl_path: str | Path | None = None):
        self.events: list[Event] = []
        self._jsonl_path = Path(jsonl_path) if jsonl_path else None
        self._fh: IO | None = None

    # ---- emission ----------------------------------------------------------
    def emit(self, kind: str, *, t: float, rid=None, slot=None, serial=None,
             block=None, **data) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        ev = Event(kind=kind, t=t, rid=rid, slot=slot, serial=serial,
                   block=block, data=data)
        self.events.append(ev)
        if self._jsonl_path is not None:
            if self._fh is None:
                self._fh = self._jsonl_path.open("w")
            self._fh.write(json.dumps(ev.to_json()) + "\n")
        return ev

    # ---- queries -----------------------------------------------------------
    def counts(self) -> Counter:
        return Counter(ev.kind for ev in self.events)

    def by_kind(self, kind: str) -> list[Event]:
        return [ev for ev in self.events if ev.kind == kind]

    def by_rid(self, rid) -> list[Event]:
        return [ev for ev in self.events if ev.rid == rid]

    # ---- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Drop the recorded stream (and truncate the JSONL sink): called at
        each ``run()`` entry so a report's event stream covers exactly the
        reported traffic."""
        self.events.clear()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._jsonl_path is not None and self._jsonl_path.exists():
            self._jsonl_path.write_text("")

    def flush(self) -> None:
        """Push buffered JSONL lines to disk without closing the sink —
        called at the end of every engine ``run()`` (including drain and
        interrupt exits) so the event tail is never lost."""
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- export ------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        from .trace import chrome_trace
        return chrome_trace(self.events)

    def write_chrome_trace(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_chrome_trace()))
        return path


def load_events_jsonl(path: str | Path) -> list[Event]:
    """Rehydrate a JSONL event stream (the ``jsonl_path`` sink format) into
    :class:`Event` objects — what ``tools/torch_trace_viewer.py`` feeds to the
    Chrome exporter."""
    events = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        events.append(Event(kind=rec["kind"], t=rec["t"],
                            rid=rec.get("rid"), slot=rec.get("slot"),
                            serial=rec.get("serial"), block=rec.get("block"),
                            data=rec.get("data", {})))
    return events
