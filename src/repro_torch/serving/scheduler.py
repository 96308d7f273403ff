"""Continuous-batching request scheduler and overload admission control.
Port of ``repro.serving.scheduler`` (numpy and the standard library only,
kept line for line so that both engines schedule a trace alike).

Lifecycle of a request::

    submit -> QUEUED -> (slot alloc) PREFILLING -> DECODING -> RETIRED
                 |            \\------------- abort ---------> RETIRED
                 |             \\------------ abort ---------> ERRORED
                 |\\-> REJECTED (infeasible: prompt/source can never fit)
                 \\--> SHED     (overload control dropped it: queue full,
                                drain, unattainable TTFT deadline)

Terminal taxonomy (every terminal state carries a machine-readable
``RequestState.code`` next to the human ``finish_reason`` string):

* **rejected** — the request could *never* be served (``prompt_too_long``,
  ``budget_too_large``, ``source_too_long``, ``source_id_without_source``);
* **shed** — the request was feasible but overload control dropped it
  before it held a slot (``queue_full``, ``ttft_unattainable``,
  ``deadline``, ``cancelled``, ``drain``);
* **retired** — the request held a slot and ended: normally (``eos`` /
  ``max_tokens``) or stopped mid-flight (``deadline``, ``cancelled``,
  ``drain``) with its partial tokens preserved;
* **errored** — the request held a slot and was quarantined with a typed
  error (``nonfinite_logits``, ``source_ingest_failed``); its slot and
  source reference were reclaimed, every other stream untouched.

The scheduler owns the host-side bookkeeping only: the FIFO admission queue
(optionally **bounded** — see :class:`OverloadConfig`), slot assignment from
the :class:`KVSlotPool`, per-request token ledgers and timing, and
retirement (EOS / max-token) with prompt backfill — a freed slot is handed
to the next queued request at the following engine step's admission, so it
never idles while work is waiting. All device work (chunked prefill, ragged
decode, cache resets, source-KV ingest for cross-attention requests) lives
in :mod:`repro_torch.serving.continuous`; the engine may also veto a request at
submit time with a precomputed ``reject`` (infeasible) or ``shed``
(overload) reason, which flows through the same terminal bookkeeping.

Conservation invariant (checked by ``assert_conservation``): every submitted
request is in exactly one of queued / prefilling / decoding / retired /
rejected / shed / errored, every admitted request reaches exactly one of
retired / errored, and no slot leaks.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from .slot_pool import KVSlotPool

QUEUED, PREFILLING, DECODING, RETIRED, REJECTED, SHED, ERRORED = (
    "queued", "prefilling", "decoding", "retired", "rejected", "shed",
    "errored")

SHED_POLICIES = ("reject", "shed-oldest", "degrade")


@dataclass(frozen=True)
class OverloadConfig:
    """Bounded-admission-queue policy for the continuous engine.

    ``max_queue`` bounds the FIFO depth; what happens on overflow is the
    ``policy``:

    * ``"reject"``   — shed the *incoming* request (code ``queue_full``);
      the queue holds a hard depth bound and earlier arrivals keep their
      positions (favors requests already waiting).
    * ``"shed-oldest"`` — shed the *oldest queued* request and enqueue the
      incoming one (favors fresh arrivals: the oldest has burned the most
      of its latency budget and is the least likely to meet any SLO).
      Also a hard depth bound.
    * ``"degrade"``  — keep everyone, but on each overflow multiply the
      ``max_new_tokens`` of every queued request (and the incoming one) by
      ``degrade_factor`` (floored at 1 token). Bounds queued *work*, not
      queue length — the depth may exceed ``max_queue``.

    Shed requests terminate with status ``"shed"`` (never an exception):
    overload is an expected operating regime, not an error."""
    max_queue: int = 64
    policy: str = "reject"
    degrade_factor: float = 0.5

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.policy not in SHED_POLICIES:
            raise ValueError(f"policy must be one of {SHED_POLICIES}, "
                             f"got {self.policy!r}")
        if not (0.0 < self.degrade_factor < 1.0):
            raise ValueError("degrade_factor must be in (0, 1)")


def _reason(value, default_code: str) -> tuple[str, str]:
    """Normalize an engine-supplied reject/shed reason: either a plain
    human-readable string (legacy callers; coded with ``default_code``) or
    a ``(code, detail)`` pair."""
    if isinstance(value, tuple):
        code, detail = value
        return str(code), str(detail)
    return default_code, str(value)


@dataclass(eq=False)               # identity equality: prompts are arrays
class Request:
    """One generation request. ``arrival`` is seconds on the engine clock
    (0.0 = already waiting when the engine starts).

    ``source``: optional [S, d] float32 encoder-side features for
    cross-attention stacks (vlm patch embeds / audio frames) — rows may
    have *heterogeneous* lengths across a trace; the serving engines pad
    and mask. ``source_id``: dedup key for the source-KV pool — requests
    presenting the same id share one pooled encoder ingest (the engine
    never compares feature bytes, only this id); ``None`` means the source
    is private to this request."""
    prompt: np.ndarray                 # [P] int32 token ids
    max_new_tokens: int
    rid: int | str | None = None
    arrival: float = 0.0
    source: np.ndarray | None = None   # [S, d] float32 frontend features
    source_id: object = None           # hashable dedup key; None -> private
    ttft_deadline_s: float | None = None   # SLO: submit -> first token
    deadline_s: float | None = None        # SLO: submit -> last token

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.source is not None:
            self.source = np.asarray(self.source, np.float32)
            if self.source.ndim != 2:
                raise ValueError(f"source must be [S, d], got "
                                 f"{self.source.shape}")
        for name in ("ttft_deadline_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and not v > 0:
                raise ValueError(f"{name} must be > 0, got {v}")

    @property
    def budget(self) -> int:
        """Cache rows the request may touch: prompt + every generated token
        except the last (which is emitted without ever being fed back, so
        it gets no KV write)."""
        return len(self.prompt) + self.max_new_tokens - 1


@dataclass(eq=False)               # identity equality: used in remove()
class RequestState:
    request: Request
    status: str = QUEUED
    slot: int | None = None
    prefilled: int = 0                 # prompt tokens already chunk-prefilled
    tokens: list = field(default_factory=list)
    token_times: list = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    finish_reason: str = ""
    code: str = ""                     # machine-readable terminal code
    degraded_from: int | None = None   # original max_new_tokens pre-degrade

    @property
    def rid(self):
        return self.request.rid

    @property
    def ttft(self) -> float | None:
        """Submit -> first emitted token (includes queueing delay)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def remaining(self) -> int:
        """Tokens still owed under the request's budget — the adaptive
        decode tick horizon is capped by the min of this over active rows
        (a row's on-device budget counter retires it at exactly this many
        more ticks, so any further fused ticks would run fully parked)."""
        return self.request.max_new_tokens - len(self.tokens)

    @property
    def itl_ms(self) -> list:
        ts = self.token_times
        return [1e3 * (b - a) for a, b in zip(ts, ts[1:])]


class Scheduler:
    """``on_event``: optional telemetry sink (``sink(kind, t=..., **data)``)
    for the queue-side lifecycle events the scheduler owns — ``enqueue`` /
    ``reject`` / ``shed`` / ``degrade`` at submit and ``admit`` (plus
    ``backfill`` when the allocated slot was freed earlier in this run) —
    so a trace shows queueing delay, slot reuse, and overload decisions
    without the engine re-deriving any of them.

    ``overload``: optional :class:`OverloadConfig`; when set the FIFO is
    bounded and overflow is resolved by the configured shed policy. When
    ``None`` (default) the queue is unbounded and ``submit`` behaves
    exactly as before overload control existed."""

    def __init__(self, pool: KVSlotPool, on_event=None,
                 overload: OverloadConfig | None = None):
        self.pool = pool
        self.overload = overload
        self.queue: deque[RequestState] = deque()
        self.prefilling: list[RequestState] = []
        self.decoding: dict[int, RequestState] = {}      # slot -> state
        self.retired: list[RequestState] = []
        self.rejected: list[RequestState] = []
        self.shed: list[RequestState] = []
        self.errored: list[RequestState] = []
        self._auto_rid = itertools.count()
        self._rids: set = set()
        self._sink = on_event
        self._recycled: set[int] = set()    # slots freed at least once
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_retired = 0
        self.n_degraded = 0

    # ---- intake -----------------------------------------------------------
    def submit(self, request: Request, now: float = 0.0,
               reject=None, shed=None) -> RequestState:
        """``reject``: an engine-computed *infeasibility* reason for
        constraints the scheduler can't see (e.g. a source longer than the
        source-KV pool rows) — the request is recorded as rejected without
        queueing, through the same bookkeeping as a capacity rejection.
        ``shed``: an engine-computed *overload* reason (unattainable TTFT
        deadline, drain in progress) — the request is feasible but dropped,
        recorded as shed. Both accept a plain string or a
        ``(code, detail)`` pair."""
        if request.rid is None:
            while (rid := f"auto-{next(self._auto_rid)}") in self._rids:
                pass
            request.rid = rid
        if request.rid in self._rids:
            raise ValueError(f"duplicate request id {request.rid!r}")
        self._rids.add(request.rid)
        state = RequestState(request=request, t_submit=now)
        self.n_submitted += 1
        if reject is None and not self.pool.fits(request.budget):
            reject = ("budget_too_large",
                      f"rejected: needs {request.budget} rows > "
                      f"slot capacity {self.pool.capacity}")
        if reject is not None:
            code, detail = _reason(reject, "infeasible")
            state.status = REJECTED
            state.finish_reason = detail
            state.code = code
            state.t_done = now
            self.rejected.append(state)
            if self._sink is not None:
                self._sink("reject", t=now, rid=state.rid, code=code,
                           reason=detail)
            return state
        if shed is None and self.overload is not None:
            shed = self._apply_overload(state, now)
        if shed is not None:
            code, detail = _reason(shed, "shed")
            self._mark_shed(state, code, detail, now)
            return state
        self.queue.append(state)
        if self._sink is not None:
            self._sink("enqueue", t=now, rid=state.rid,
                       queue_depth=len(self.queue))
        return state

    # ---- overload control --------------------------------------------------
    def _apply_overload(self, incoming: RequestState, now: float):
        """Resolve a queue overflow per the configured policy. Returns a
        shed reason for the *incoming* request, or ``None`` if it may be
        enqueued (possibly after shedding or degrading others)."""
        cfg = self.overload
        if len(self.queue) < cfg.max_queue:
            return None
        if cfg.policy == "reject":
            return ("queue_full",
                    f"shed: queue full ({len(self.queue)} >= "
                    f"{cfg.max_queue}, policy=reject)")
        if cfg.policy == "shed-oldest":
            victim = self.queue.popleft()
            self._mark_shed(
                victim, "queue_full",
                f"shed: oldest queued dropped for {incoming.rid!r} "
                f"(queue {cfg.max_queue} full, policy=shed-oldest)", now)
            return None
        # degrade: shrink everyone's decode budget; queue depth may grow.
        for st in list(self.queue) + [incoming]:
            req = st.request
            new = max(1, int(req.max_new_tokens * cfg.degrade_factor))
            if new == req.max_new_tokens:
                continue
            if st.degraded_from is None:
                st.degraded_from = req.max_new_tokens
            self.n_degraded += 1
            if self._sink is not None:
                self._sink("degrade", t=now, rid=st.rid,
                           from_tokens=req.max_new_tokens, to_tokens=new)
            req.max_new_tokens = new
        return None

    def _mark_shed(self, state: RequestState, code: str, detail: str,
                   now: float) -> None:
        state.status = SHED
        state.finish_reason = detail
        state.code = code
        state.t_done = now
        self.shed.append(state)
        if self._sink is not None:
            self._sink("shed", t=now, rid=state.rid, code=code,
                       reason=detail)

    def shed_queued(self, state: RequestState, code: str, now: float,
                    detail: str | None = None) -> None:
        """Shed a request that is still QUEUED (deadline expiry while
        waiting, client cancellation, drain). The request never held a
        slot, so there is nothing to reclaim."""
        assert state.status == QUEUED, state.status
        self.queue.remove(state)
        self._mark_shed(state, code, detail or f"shed: {code}", now)

    def admit(self, now: float) -> list[RequestState]:
        """Backfill free slots from the queue (FIFO). Called at the top of
        every engine step, so a slot freed by a retirement is backfilled at
        the following step and never idles while work is waiting."""
        newly = []
        while self.queue and self.pool.n_free:
            state = self.queue.popleft()
            state.slot = self.pool.alloc(state.rid)
            state.status = PREFILLING
            state.t_admit = now
            self.n_admitted += 1
            self.prefilling.append(state)
            newly.append(state)
            if self._sink is not None:
                self._sink("admit", t=now, rid=state.rid, slot=state.slot,
                           queued_s=round(now - state.t_submit, 6))
                if state.slot in self._recycled:
                    self._sink("backfill", t=now, rid=state.rid,
                               slot=state.slot)
        return newly

    # ---- transitions ------------------------------------------------------
    def start_decoding(self, state: RequestState) -> None:
        assert state.status == PREFILLING and state.slot is not None
        self.prefilling.remove(state)
        self.pool.set_length(state.slot, len(state.request.prompt))
        state.status = DECODING
        self.decoding[state.slot] = state

    def retire(self, state: RequestState, reason: str, now: float,
               code: str | None = None) -> int:
        """Free the slot and record the outcome; returns the freed slot so
        the engine can reset the device-side cache entry."""
        assert state.status == DECODING
        slot = state.slot
        self.decoding.pop(slot)
        self.pool.release(slot)
        state.status = RETIRED
        state.finish_reason = reason
        state.code = code if code is not None else reason
        state.t_done = now
        state.slot = None
        self.retired.append(state)
        self.n_retired += 1
        self._recycled.add(slot)
        return slot

    def abort(self, state: RequestState, code: str, now: float, *,
              error: bool = False, detail: str | None = None) -> int:
        """Stop a request that currently *holds a slot* (PREFILLING or
        DECODING) before its natural end, freeing the slot. With
        ``error=False`` the request retires normally with the given code
        (deadline miss, cancellation, drain) and keeps any tokens already
        generated; with ``error=True`` it terminates as ERRORED (typed
        fault — poisoned logits, failed source ingest). Returns the freed
        slot so the engine can reset the device-side cache entry (errored
        requests do **not** count toward ``n_retired``: conservation
        tracks them separately so a clean run pins ``n_retired ==
        len(trace)`` exactly)."""
        assert state.status in (PREFILLING, DECODING), state.status
        slot = state.slot
        if state.status == PREFILLING:
            self.prefilling.remove(state)
        else:
            self.decoding.pop(slot)
        self.pool.release(slot)
        state.finish_reason = detail or code
        state.code = code
        state.t_done = now
        state.slot = None
        if error:
            state.status = ERRORED
            self.errored.append(state)
        else:
            state.status = RETIRED
            self.retired.append(state)
            self.n_retired += 1
        self._recycled.add(slot)
        return slot

    def reset_stats(self) -> None:
        """Forget finished-traffic history (retired / rejected records, their
        rids, and the counters) while keeping live state — queue, prefilling,
        decoding, slot ownership — intact. Used by engine warmup so reports
        cover only real traffic."""
        self.retired.clear()
        self.rejected.clear()
        self.shed.clear()
        self.errored.clear()
        self._recycled.clear()   # a post-reset admit is a fresh alloc again
        self._rids = {s.rid for s in self.all_states()}
        self.n_submitted = (len(self.queue) + len(self.prefilling)
                            + len(self.decoding))
        self.n_admitted = len(self.prefilling) + len(self.decoding)
        self.n_retired = 0
        self.n_degraded = 0

    # ---- queries ----------------------------------------------------------
    def pending(self) -> bool:
        return bool(self.queue or self.prefilling or self.decoding)

    def all_states(self) -> Iterable[RequestState]:
        return itertools.chain(self.queue, self.prefilling,
                               self.decoding.values(), self.retired,
                               self.rejected, self.shed, self.errored)

    def assert_conservation(self) -> None:
        """Every submitted request is in exactly one bucket; every admitted
        request reached exactly one of retired / errored; terminal records
        carry their typed code; no slot leaks."""
        in_flight = (len(self.queue) + len(self.prefilling)
                     + len(self.decoding))
        assert self.n_submitted == (in_flight + len(self.retired)
                                    + len(self.rejected) + len(self.shed)
                                    + len(self.errored)), vars(self)
        assert self.n_admitted == (len(self.prefilling) + len(self.decoding)
                                   + self.n_retired + len(self.errored))
        assert self.n_retired == len(self.retired)
        assert self.pool.n_used == len(self.prefilling) + len(self.decoding)
        for bucket in (self.retired, self.rejected, self.shed, self.errored):
            for st in bucket:
                assert st.code, f"terminal state without code: {st.rid!r}"
                assert st.slot is None, f"terminal state holds a slot: " \
                                        f"{st.rid!r}"
        rids = [s.rid for s in self.all_states()]
        assert len(rids) == len(set(rids)), "request tracked twice"
        self.pool.assert_consistent()
