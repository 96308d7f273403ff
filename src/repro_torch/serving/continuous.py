"""Continuous-batching serving engine: slot pool -> scheduler -> chunked slot
prefill -> static-shape ragged decode in multi-tick blocks. Port of
``repro.serving.continuous.ContinuousBatchingEngine`` for every family of
the port (dense, MoE, RWKV6, hybrid and the cross-attention stacks).

The decode step always runs at the ``[n_slots]`` batch shape; an ``active``
mask says which slots hold live requests. Each engine step:

1. **admit**: backfill free slots from the FIFO admission queue;
2. **prefill**: every mid-prefill slot advances one prompt chunk
   (``TransformerLM.prefill_chunks_batched``); a request whose final chunk
   lands is committed (``finalize_slot``), its first token picked from the
   chunk's logits (one host sync), and its slot joins the active set;
3. **decode**: one ``decode_multi`` block of K ragged ticks with picking
   and retirement on the device, then one host sync on the ``[K, n_slots]``
   token block, from which the host replays the block's bookkeeping;
   retired slots are released and backfilled at the next step.

The tick horizon adapts per block::

    K = min(decode_ticks, min remaining budget among active rows)
    K = 1 while prefill chunks are waiting                 # TTFT first
    K capped so the block ends by the next timed arrival   # when a slot is free
    K floored to a power of two

A request's tokens depend on nothing but the request: its rows of the cache
are its own, the kernels' plans come from shapes alone (the cache is always
``[n_slots]``), and sampled tokens draw from the key ``(seed, admission
serial, token index)`` (:func:`repro_torch.core.prng.seeded_gumbel_pick`),
so batch composition and the tick horizon change no token.

Dispatch accounting follows the reference: a *dispatch* is one call of a
model entry point (a prefill batch, a finalize, a first-token pick, a
decode block, a release), each of which issues many kernels here; a *host
sync* is one blocking device-to-host read (one per decode block and one
per first token). ``parked_ticks`` counts ticks issued to rows that had
retired inside the block.

Cross-attention models (vision, whisper) keep a second, refcounted pool of
source K/V entries keyed by source id (``SourceKVPool``, ``n_slots``
entries): a request's source is ingested at admission (the encoder and the
cross layers' K/V projections, once per distinct id), shared read-only by
every slot whose request presents the same id, and its entry zeroed when
the last holder retires. A request without a source takes an entry whose
``src_len`` stays 0: its cross terms are an exact 0.

Robustness and observability, all off by default (each consult site is one
``None`` or falsy check, so the default engine runs the bare host loop):
``telemetry=`` (:class:`Telemetry`: lifecycle events and per-block gauges),
``overload=`` (:class:`OverloadConfig`: the bounded queue and its shed
policies, and the predicted-TTFT gate at submit), per-request deadlines,
:meth:`cancel` and :meth:`drain`, ``faults=`` (:class:`FaultPlan`:
``poison_nan`` through ``decode_multi(poison=)`` and the quarantine of the
``-2`` row, ``ingest_fail``, ``dispatch_fail``, ``tick_delay``) and
``auditor=`` (:class:`EngineAuditor`, after each decode block). A
``KeyboardInterrupt`` inside ``run()`` unwinds into a typed report
(``interrupted: true``).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.api import needs_source
from repro_torch.models.quantized import quantize_params

from .audit import EngineAuditor
from .faults import FaultInjected, FaultPlan
from .scheduler import PREFILLING, QUEUED, OverloadConfig, Request, RequestState, Scheduler
from .slot_pool import KVSlotPool, SourceKVPool
from .telemetry import LogHistogram, Telemetry

_KV_KEYS = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v", "src_k", "src_v",
            "src_k_scale", "src_v_scale")


class ContinuousBatchingEngine:
    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 chunk: int = 16, eos_id: int | None = None,
                 pad_id: int = 0, temperature: float = 0.0, seed: int = 0,
                 decode_ticks: int = 1, source_len: int | None = None,
                 telemetry: Telemetry | None = None,
                 overload: OverloadConfig | None = None,
                 faults: FaultPlan | None = None,
                 auditor: EngineAuditor | None = None):
        if not getattr(model, "supports_ragged_serving", lambda: False)():
            raise ValueError(f"{model.cfg.name}: model does not claim ragged "
                             "serving (supports_ragged_serving() is False)")
        if chunk < 1 or max_len % chunk:
            raise ValueError(f"chunk ({chunk}) must divide max_len "
                             f"({max_len}) so padded chunks stay in range")
        if decode_ticks < 1:
            raise ValueError(f"decode_ticks must be >= 1, got {decode_ticks}")
        if model.cfg.w4a8_serve:
            # one-shot weight quantization at construction (deterministic);
            # the int8 KV side is init_cache's default for +w4a8
            params = quantize_params(params)
        self.model, self.params = model, params
        self.device = model.device
        self.chunk, self.eos_id, self.pad_id = chunk, eos_id, pad_id
        self.temperature = temperature
        self.max_ticks = decode_ticks
        self._t0 = time.perf_counter()          # reset by run()
        # telemetry: self._sink is None when disabled, so every emission
        # site is one falsy check and the disabled path is the bare loop
        self.tel = telemetry
        if telemetry is None:
            self._sink = None
        else:
            def _sink(kind, t=None, **data):
                telemetry.emit(kind, t=(time.perf_counter() - self._t0
                                        if t is None else t), **data)
            self._sink = _sink
        self.pool = KVSlotPool(n_slots, max_len)
        self.sched = Scheduler(self.pool, on_event=self._sink, overload=overload)
        # robustness knobs, all off by default; each consult site below is
        # one None or falsy check
        self.faults = faults          # FaultPlan | None; settable after warmup
        self.auditor = auditor        # EngineAuditor | None
        self._draining = False
        self._interrupted = False
        self._cancels: set = set()
        self._n_deadlined = 0         # submitted requests carrying a deadline
        self._shed_seen = 0           # prefix of sched.shed already reclaimed
        self.dispatch_retries = 0
        # service-time EWMAs of the predicted-TTFT gate: the admit-to-first-
        # token wall per prefill chunk, and a request's slot-hold time
        self._chunk_s = 0.0
        self._svc_s = 0.0
        # sampler keys: (seed, admission serial, token index)
        self._base_key = prng.prng_key(seed, device=self.device)
        cfg = model.cfg
        # cross-attention models: the source-KV pool, one entry per slot, so
        # an entry is free whenever a slot is
        self.needs_source = needs_source(cfg)
        self.src_pool = None
        if self.needs_source:
            self.src_max = source_len or cfg.source_len
            self.src_pool = SourceKVPool(n_slots, self.src_max, on_event=self._sink)
            self._srcs: dict = {}           # rid -> the source id it holds
        if self.needs_source:
            self.cache = model.init_cache(n_slots, max_len, self.src_max, n_sources=n_slots,
                                          chunk=chunk)
        else:
            self.cache = model.init_cache(n_slots, max_len, chunk=chunk)
        if cfg.kv_ring and cfg.window:
            # ring-prefill exactness bound: a chunk's later tokens may
            # overwrite ring slots its earlier queries still need unless
            # the overwritten positions are already outside every live
            # window, which holds iff ring_len >= window + chunk - 1.
            # init_cache(chunk=) sizes the ring so that it holds (a ring
            # that reaches max_len is the never-wrapping full cache); this
            # is the safety check behind it
            ring_len = int(self.cache["k"].shape[2])
            if ring_len < max_len and chunk > ring_len - cfg.window + 1:
                raise ValueError(
                    f"chunk ({chunk}) too large for the ring: a "
                    f"{ring_len}-slot ring over window {cfg.window} "
                    f"supports chunks up to {ring_len - cfg.window + 1} "
                    "(ring_len >= window + chunk - 1 keeps chunked "
                    "prefill exact under wraparound)")
        # the live-KV gauge: self-attention KV bytes per (slot, row)
        self._kv_rows = int(self.cache["k"].shape[2]) if "k" in self.cache else 0
        kv_self = [self.cache[k] for k in ("k", "v", "k_scale", "v_scale")
                   if k in self.cache]
        self._kv_row_bytes = (sum(a.numel() * a.element_size() for a in kv_self)
                              // (n_slots * self._kv_rows) if self._kv_rows else 0)
        self.hist_ttft = LogHistogram()
        self.hist_itl = LogHistogram()
        self.tok = np.full((n_slots,), pad_id, np.int32)
        self.active = np.zeros((n_slots,), bool)
        # per-slot sampler / retirement state, copied to the device per
        # block: admission serial of the occupant, tokens emitted so far
        # (the next draw's token index) and its allowance
        self.serial = np.zeros((n_slots,), np.int32)
        self.emitted = np.zeros((n_slots,), np.int32)
        self.budget = np.zeros((n_slots,), np.int32)
        self._serials: dict = {}        # rid -> serial, queued or prefilling
        self._serial_ctr = 0
        # EWMA of one tick's wall time, to cap the horizon ahead of the
        # next timed arrival when a free slot waits for it
        self._tick_s = 0.0
        self._zero_counters()

    def _zero_counters(self) -> None:
        self.decode_steps = 0           # executed ticks with >= 1 live row
        self.decode_dispatches = 0      # decode blocks
        self.decode_ticks_run = 0       # sum of K over decode blocks
        self.prefill_chunks = 0         # chunk advances (rows, not calls)
        self.prefill_dispatches = 0     # prefill_chunks_batched calls
        self.active_row_steps = 0
        self.dispatches = 0             # every model entry-point call
        self.host_syncs = 0             # blocking device -> host reads
        self.issued_ticks = 0           # K * active rows, per decode block
        self.parked_ticks = 0           # issued - emitted

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array's copy on the model's device: through pinned memory
        and asynchronous on the GPU, so it waits for no queued work."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone().to(self.device)

    # ---- intake -----------------------------------------------------------
    def submit(self, request: Request, now: float = 0.0) -> RequestState:
        """Typed submit-time validation: a request the engine can never
        serve ends as a rejection with its ``code``; a feasible one that
        overload control drops (drain, the bounded queue, an unattainable
        TTFT deadline) ends as ``shed``."""
        reject = shed = None
        if len(request.prompt) > self.pool.capacity:
            reject = ("prompt_too_long",
                      f"rejected: prompt of {len(request.prompt)} tokens > "
                      f"slot capacity {self.pool.capacity}")
        elif self.needs_source:
            if request.source is not None and len(request.source) > self.src_max:
                reject = ("source_too_long",
                          f"rejected: source of {len(request.source)} rows "
                          f"> source-KV pool rows {self.src_max}")
            elif request.source is None and request.source_id is not None:
                # a shared id must be ingestable by whichever holder comes
                # first: an id without features would leave the entry empty
                # for every later sharer
                reject = ("source_id_without_source",
                          "rejected: source_id "
                          f"{request.source_id!r} without source features "
                          "(a shared entry must be ingestable by its "
                          "first holder)")
        if reject is None:
            if self._draining:
                shed = ("drain", "shed: engine is draining")
            elif (request.ttft_deadline_s is not None
                  and self.sched.overload is not None):
                est = self._predict_ttft(request)
                if est is not None and est > request.ttft_deadline_s:
                    shed = ("ttft_unattainable",
                            f"shed: predicted TTFT {est:.4f}s > deadline "
                            f"{request.ttft_deadline_s:.4f}s")
        state = self.sched.submit(request, now, reject=reject, shed=shed)
        if state.status == QUEUED:
            # admission is FIFO over submission, so the serial is a
            # property of the trace
            self._serials[state.rid] = self._serial_ctr
            self._serial_ctr += 1
            if request.ttft_deadline_s is not None or request.deadline_s is not None:
                self._n_deadlined += 1
        self._sync_shed_serials()
        return state

    def _sync_shed_serials(self) -> None:
        """Drop the sampler serials of requests shed while queued (the
        shed-oldest policy evicts inside the scheduler, so the engine reads
        the shed list's new suffix)."""
        shed = self.sched.shed
        while self._shed_seen < len(shed):
            self._serials.pop(shed[self._shed_seen].rid, None)
            self._shed_seen += 1

    def _predict_ttft(self, request: Request) -> float | None:
        """TTFT estimate of an arriving request from the EWMAs: the queue's
        waves ahead of it (plus one when no slot is free) times the
        slot-hold EWMA, plus its own chunks times the per-chunk EWMA.
        ``None`` until both EWMAs exist: a cold engine never sheds."""
        if self._chunk_s == 0.0 or self._svc_s == 0.0:
            return None
        waves = len(self.sched.queue) / self.pool.n_slots
        if self.pool.n_free == 0:
            waves += 1.0
        chunks = math.ceil(len(request.prompt) / self.chunk)
        return waves * self._svc_s + chunks * self._chunk_s

    # ---- overload / lifecycle control --------------------------------------
    def cancel(self, rid) -> None:
        """Client cancellation, applied at the next step boundary: a queued
        request sheds (``cancelled``), an in-flight one retires with its
        partial tokens and its slot and source reference reclaimed. An
        unknown or finished rid is dropped (cancellation races completion)."""
        self._cancels.add(rid)

    def drain(self) -> None:
        """Graceful shutdown: later submits shed with code ``drain``, the
        queue sheds at the next step boundary, in-flight requests finish;
        ``run()`` returns when the last of them retires."""
        self._draining = True
        if self._sink is not None:
            self._sink("drain", t=time.perf_counter() - self._t0,
                       queued=len(self.sched.queue),
                       in_flight=len(self.sched.prefilling) + len(self.sched.decoding))

    def _enforce_control(self, now: float) -> None:
        """Step-boundary control: drain sheds the queue; cancellations and
        expired deadlines shed queued requests or retire in-flight ones with
        their slot and source reclaimed. ``step`` calls it only when one of
        the three triggers is live."""
        if self._draining:
            for st in list(self.sched.queue):
                self.sched.shed_queued(st, "drain", now, detail="shed: engine draining")
        if self._cancels:
            live = {st.rid: st for st in list(self.sched.queue)
                    + list(self.sched.prefilling)
                    + list(self.sched.decoding.values())}
            for rid in list(self._cancels):
                st = live.get(rid)
                if st is not None:
                    if st.status == QUEUED:
                        self.sched.shed_queued(st, "cancelled", now,
                                               detail="shed: cancelled by client")
                    else:
                        self._reclaim(st, "cancelled", now, detail="cancelled by client")
                self._cancels.discard(rid)
        if self._n_deadlined:
            for st in list(self.sched.queue):
                r = st.request
                missed = ((r.deadline_s is not None
                           and now - st.t_submit > r.deadline_s)
                          or (r.ttft_deadline_s is not None
                              and now - st.t_submit > r.ttft_deadline_s))
                if missed:
                    self.sched.shed_queued(
                        st, "deadline", now,
                        detail=f"shed: deadline expired after "
                               f"{now - st.t_submit:.4f}s in queue")
            for st in list(self.sched.prefilling) + list(self.sched.decoding.values()):
                r = st.request
                missed = ((r.deadline_s is not None
                           and now - st.t_submit > r.deadline_s)
                          or (st.t_first is None
                              and r.ttft_deadline_s is not None
                              and now - st.t_submit > r.ttft_deadline_s))
                if missed:
                    self._reclaim(st, "deadline", now,
                                  detail=f"deadline missed after "
                                         f"{now - st.t_submit:.4f}s")
        self._sync_shed_serials()

    def _reclaim(self, state: RequestState, code: str, now: float, *,
                 error: bool = False, detail: str | None = None,
                 device: bool = True) -> int:
        """Stop a slot-holding request before its natural end and reclaim
        what it owns, in ``_emit``'s retirement order: the scheduler records
        the typed terminal state (RETIRED with partial tokens, or ERRORED
        with ``error``), the slot's device rows reset, its source reference
        dropped (the entry zeroed when it was the last). ``device=False``
        (the ``KeyboardInterrupt`` unwinding: a model call may have been cut
        short mid-update) cleans the host ledgers only."""
        serial = self._serials.get(state.rid)
        was_prefilling = state.status == PREFILLING
        slot = self.sched.abort(state, code, now, error=error, detail=detail)
        if was_prefilling:
            self._serials.pop(state.rid, None)
        else:
            serial = int(self.serial[slot])
        if device:
            self.cache = self.model.release_slot(self.cache, slot)
            self.dispatches += 1
        if self.needs_source and state.rid in self._srcs:
            freed = self.src_pool.release(self._srcs.pop(state.rid), owner=state.rid)
            if freed is not None and device:
                self.cache = self.model.release_source(self.cache, freed)
                self.dispatches += 1
        if self._sink is not None:
            self._sink("error_retire" if error else "abort", t=now,
                       rid=state.rid, slot=slot, serial=serial, code=code,
                       n_tokens=len(state.tokens))
            self._sink("release", t=now, rid=state.rid, slot=slot, serial=serial)
        self.active[slot] = False
        self.tok[slot] = self.pad_id
        self.budget[slot] = 0
        self._note_service(state, now)
        return slot

    def _note_service(self, state: RequestState, now: float) -> None:
        """The slot-hold EWMA of the predicted-TTFT gate (host math only)."""
        if state.t_admit is None:
            return
        hold = max(0.0, now - state.t_admit)
        self._svc_s = hold if self._svc_s == 0.0 else 0.5 * self._svc_s + 0.5 * hold

    def _quarantine(self, slot: int, now: float) -> None:
        """A decode row reported the ``-2`` non-finite-logits sentinel:
        retire exactly that request as ERRORED and reclaim its slot and
        source; the other rows never read this slot's state."""
        state = self.sched.decoding[slot]
        self._reclaim(state, "nonfinite_logits", now, error=True,
                      detail="errored: non-finite logits row (quarantined "
                             "by the on-device finite check)")

    def warmup(self) -> "ContinuousBatchingEngine":
        """Run a throwaway request whose budget (2 x decode_ticks) walks the
        adaptive horizon down through every power-of-two K, so that kernel
        libraries, allocator pools and library handles are set up before
        timing. ``run`` drops its stats; it takes one sampler serial, so two
        warmed-up engines with one seed still draw the same streams."""
        m_want = 2 * self.max_ticks
        p = max(1, min(self.chunk + 1, self.pool.capacity - m_want))
        m = max(2, min(m_want, self.pool.capacity - p))
        src = (np.zeros((self.src_max, self.model.cfg.d_model), np.float32)
               if self.needs_source else None)   # sets up the ingest path too
        # the fault plan must not spend its faults on the warmup request
        faults, self.faults = self.faults, None
        try:
            self.run([Request(prompt=np.zeros(p, np.int32), max_new_tokens=m,
                              rid="__warmup__", source=src)])
        finally:
            self.faults = faults
        return self

    # ---- horizon -----------------------------------------------------------
    def _tick_horizon(self, now: float | None = None,
                      deadline: float | None = None) -> int:
        """K = min(decode_ticks, min remaining budget among active rows),
        1 while prefill chunks wait, capped so that the block ends by
        ``deadline`` (the next timed arrival while a slot is free, from the
        per-tick EWMA), capped so that it ends near an in-flight request's
        total deadline, floored to a power of two."""
        if self.max_ticks == 1 or self.sched.prefilling:
            return 1
        rem = min(s.remaining for s in self.sched.decoding.values())
        k = max(1, min(self.max_ticks, rem))
        if deadline is not None and now is not None and self._tick_s > 0:
            k = max(1, min(k, int((deadline - now) / self._tick_s)))
        if self._n_deadlined and now is not None and self._tick_s > 0:
            # enforcement runs at step boundaries: end the block near the
            # deadline rather than up to K-1 ticks of dead work past it
            for st in self.sched.decoding.values():
                d = st.request.deadline_s
                if d is not None:
                    left = st.t_submit + d - now
                    k = max(1, min(k, max(1, int(left / self._tick_s))))
        return 1 << (k.bit_length() - 1)

    # ---- one engine step --------------------------------------------------
    @torch.no_grad()
    def step(self, now: float | None = None,
             deadline: float | None = None) -> bool:
        """Admit, advance every prefilling slot one chunk, run one K-tick
        decode block. Returns False when nothing was left to do."""
        now = (time.perf_counter() - self._t0) if now is None else now
        if self._draining or self._cancels or self._n_deadlined:
            self._enforce_control(now)
        newly = self.sched.admit(now)
        if self.needs_source:
            # ingest at admission, before the request's first chunk: the
            # chunk's cross reads need the entry resident
            for st in newly:
                if self.faults is not None and self.faults.take_ingest(st.rid) is not None:
                    # injected ingest failure: quarantine before any device
                    # write; the slot is free again this step
                    if self._sink is not None:
                        self._sink("fault", t=now, rid=st.rid, fault="ingest_fail")
                    self._reclaim(st, "source_ingest_failed", now, error=True,
                                  detail="errored: source-KV ingest failed")
                    continue
                self._acquire_source(st)
        if self.sched.prefilling:
            self._advance_prefills()
        if not self.active.any():
            return self.sched.pending()

        k = self._tick_horizon(now, deadline)
        live_slots = np.flatnonzero(self.active)
        blk_idx = self.decode_dispatches
        poison = None
        if self.faults is not None:
            poison = self._inject_faults(blk_idx)
        t_dispatch = time.perf_counter()
        toks, _, _, self.cache = self.model.decode_multi(
            self.params, self._to_device(self.tok), self.cache,
            self._to_device(self.active), self._to_device(self.budget),
            self._to_device(self.serial), self._to_device(self.emitted), k,
            eos_id=self.eos_id, temperature=self.temperature,
            base_key=self._base_key, poison=poison)
        self.decode_dispatches += 1
        self.decode_ticks_run += k
        self.dispatches += 1
        rows = toks.cpu().numpy()                # [K, n_slots]; the one sync
        self.host_syncs += 1
        # the block's tokens all arrive at this sync: stamps inside the
        # block are attributed by even subdivision of its wall span
        now_blk = time.perf_counter() - self._t0
        blk_start = t_dispatch - self._t0
        span = now_blk - blk_start
        per_tick = span / k
        self._tick_s = (per_tick if self._tick_s == 0.0
                        else 0.5 * self._tick_s + 0.5 * per_tick)
        emitted_blk = 0
        quarantined = []
        for t in range(k):
            live = rows[t] >= 0                  # -1 marks parked rows
            bad = rows[t] == -2                  # non-finite logits: quarantine
            if not live.any() and not bad.any():
                break                            # every row retired mid-block
            stamp = blk_start + (t + 1) * per_tick
            if live.any():
                self.decode_steps += 1
                self.active_row_steps += int(live.sum())
                emitted_blk += int(live.sum())
                for slot in np.flatnonzero(live):
                    state = self.sched.decoding[int(slot)]
                    self.pool.advance(int(slot))
                    self._emit(state, int(rows[t, slot]), stamp)
            for slot in np.flatnonzero(bad):
                quarantined.append(int(slot))
                self._quarantine(int(slot), stamp)
        issued = k * len(live_slots)
        self.issued_ticks += issued
        self.parked_ticks += issued - emitted_blk
        if self._sink is not None:
            extra = {"quarantined": quarantined} if quarantined else {}
            self._sink(
                "decode_block", t=now_blk, block=blk_idx, k=k,
                dur=round(span, 6), emitted=emitted_blk,
                parked=issued - emitted_blk,
                slots=[int(s) for s in live_slots],
                serials=[int(self.serial[s]) for s in live_slots],
                tokens_per_slot=[int((rows[:k, s] >= 0).sum()) for s in live_slots],
                **extra)
            self._sample_gauges(now_blk, blk_idx, k, issued - emitted_blk)
        if self.auditor is not None:
            self.auditor.maybe_check(self)
        return True

    def _inject_faults(self, blk_idx: int) -> torch.Tensor | None:
        """The fault plan's decode seams, before the block's dispatch: a
        ``tick_delay`` stall, ``dispatch_fail`` retries (raised before the
        model call, so the cache is untouched), and the ``poison_nan`` mask
        of the victims decoding in this block (None when none fires)."""
        d = self.faults.take("tick_delay", block=blk_idx)
        if d is not None:
            if self._sink is not None:
                self._sink("fault", t=time.perf_counter() - self._t0, block=blk_idx,
                           fault="tick_delay", delay_s=d.delay_s)
            time.sleep(d.delay_s)
        while True:
            try:
                self.faults.raise_if("dispatch_fail", block=blk_idx)
                break
            except FaultInjected:
                self.dispatch_retries += 1
                if self._sink is not None:
                    self._sink("fault", t=time.perf_counter() - self._t0,
                               block=blk_idx, fault="dispatch_fail",
                               retry=self.dispatch_retries)
        hits = self.faults.take_poison(
            {st.rid: len(st.tokens) for st in self.sched.decoding.values()}, blk_idx)
        if not hits:
            return None
        mask = np.zeros((self.pool.n_slots,), bool)
        for slot, st in self.sched.decoding.items():
            if st.rid in hits:
                mask[slot] = True
        if self._sink is not None:
            self._sink("fault", t=time.perf_counter() - self._t0, block=blk_idx,
                       fault="poison_nan", rids=list(hits))
        return self._to_device(mask)

    def _sample_gauges(self, t: float, block: int, k: int, parked: int) -> None:
        """Engine gauges at a decode block's sync: occupancy, queue and free
        slots, live KV bytes (rows holding committed context), the tick
        horizon and the block's parked ticks."""
        g = dict(
            active_slots=int(self.active.sum()),
            free_slots=self.pool.n_free,
            queue_depth=len(self.sched.queue),
            prefilling=len(self.sched.prefilling),
            occupancy=round(self.pool.n_used / self.pool.n_slots, 3),
            tick_k=k,
            parked_ticks_block=parked,
            parked_ticks_total=self.parked_ticks,
            kv_bytes_live=self._kv_row_bytes * sum(
                min(self.pool.length(int(s)), self._kv_rows)
                for s in np.flatnonzero(self.active)),
        )
        if self.src_pool is not None:
            g["src_entries_used"] = self.src_pool.n_used
            g["src_refs"] = sum(self.src_pool.refcount(e)
                                for e in range(self.src_pool.n_entries))
        self._sink("gauges", t=t, block=block, **g)

    def _acquire_source(self, st: RequestState) -> None:
        """A newly admitted request's pool entry: the resident entry of its
        source id (shared, no ingest) or a fresh one, ingested once from
        the source padded to the pool's rows; then the slot points at it.
        A request without a source takes a fresh entry and ingests nothing
        (the entry is zero, ``src_len`` 0)."""
        req = st.request
        sid = req.source_id if req.source_id is not None else ("__rid__", st.rid)
        entry, fresh = self.src_pool.acquire(sid, owner=st.rid)
        if entry is None:
            raise RuntimeError("source pool exhausted with a free slot")
        self._srcs[st.rid] = sid
        if fresh and req.source is not None:
            padded = np.zeros((self.src_max, self.model.cfg.d_model), np.float32)
            padded[:len(req.source)] = req.source
            self.cache = self.model.ingest_source(self.params, self._to_device(padded),
                                                  self.cache, entry, len(req.source))
            self.dispatches += 1
        self.cache = self.model.assign_source(self.cache, st.slot, entry)
        self.dispatches += 1

    def _advance_prefills(self) -> None:
        """Advance every mid-prefill slot one chunk; finalized requests pick
        their first token from their chunk's logits row (one scalar read)."""
        states = list(self.sched.prefilling)
        n = self.pool.n_slots
        toks = np.full((n, self.chunk), self.pad_id, np.int32)
        slots, offs, lasts, valid = [0] * n, [0] * n, [0] * n, [False] * n
        sizes = [0] * n
        for i, st in enumerate(states):
            prompt = st.request.prompt
            off = st.prefilled
            part = prompt[off:off + self.chunk]
            toks[i, :part.size] = part
            slots[i], offs[i] = st.slot, off
            lasts[i] = min(self.chunk - 1, max(0, len(prompt) - 1 - off))
            valid[i] = True
            sizes[i] = int(part.size)
        blk_idx = self.prefill_dispatches
        t_dispatch = time.perf_counter()
        logits, self.cache = self.model.prefill_chunks_batched(
            self.params, self._to_device(toks), self.cache, slots, offs, lasts,
            valid)
        self.prefill_dispatches += 1
        self.dispatches += 1
        self.prefill_chunks += len(states)
        if self._sink is not None:
            # one slice per advanced slot, sharing the batched call's host
            # span (the kernels retire asynchronously)
            t_done = time.perf_counter()
            dur = round(t_done - t_dispatch, 6)
            for i, st in enumerate(states):
                self._sink("prefill_chunk", t=t_done - self._t0, rid=st.rid,
                           slot=st.slot, serial=self._serials.get(st.rid),
                           block=blk_idx, offset=int(offs[i]),
                           n_tokens=sizes[i], dur=dur)
        for i, st in enumerate(states):
            prompt = st.request.prompt
            st.prefilled = min(st.prefilled + self.chunk, len(prompt))
            if st.prefilled < len(prompt):
                continue                         # logits stay on the device
            self.cache = self.model.finalize_slot(self.cache, st.slot, len(prompt))
            self.dispatches += 1
            self.sched.start_decoding(st)
            self.serial[st.slot] = self._serials.pop(st.rid)
            self.budget[st.slot] = st.request.max_new_tokens
            tok0 = int(self._first_pick(logits[i], int(self.serial[st.slot])))
            self.dispatches += 1
            self.host_syncs += 1
            t_tok0 = time.perf_counter() - self._t0
            # admit-to-first-token wall per chunk (the decode blocks between
            # chunks included): the predicted-TTFT gate's chunk EWMA
            per_chunk = (max(0.0, t_tok0 - st.t_admit)
                         / max(1, math.ceil(len(prompt) / self.chunk)))
            self._chunk_s = (per_chunk if self._chunk_s == 0.0
                             else 0.5 * self._chunk_s + 0.5 * per_chunk)
            if self._sink is not None:
                self._sink("first_token", t=t_tok0, rid=st.rid, slot=st.slot,
                           serial=int(self.serial[st.slot]), token=tok0)
            self._emit(st, tok0, t_tok0)

    def _first_pick(self, logits_row: torch.Tensor, serial: int) -> torch.Tensor:
        """Token 0 of a request: argmax, or the draw of token index 0 from
        the same (seed, serial, index) stream decode_multi draws 1..n from."""
        if self.temperature == 0.0:
            return logits_row.argmax()
        return prng.seeded_gumbel_pick(self._base_key, logits_row, serial, 0,
                                       self.temperature)

    def _emit(self, state: RequestState, token: int, now: float) -> None:
        if state.token_times:
            self.hist_itl.add(max(0.0, now - state.token_times[-1]))
        state.tokens.append(token)
        state.token_times.append(now)
        if state.t_first is None:
            state.t_first = now
            self.hist_ttft.add(max(0.0, now - state.t_submit))
        done = self.eos_id is not None and token == self.eos_id
        if done or len(state.tokens) >= state.request.max_new_tokens:
            # mirrors decode_multi's retirement: the device flipped this
            # row's active bit at the same tick
            if self._sink is not None:
                self._sink("eos" if done else "budget_retire", t=now,
                           rid=state.rid, slot=state.slot,
                           serial=int(self.serial[state.slot]),
                           n_tokens=len(state.tokens))
            slot = self.sched.retire(state, "eos" if done else "max_tokens", now)
            self.cache = self.model.release_slot(self.cache, slot)
            self.dispatches += 1
            if self.needs_source:
                # drop the source reference; zero the entry only when this
                # was its last holder
                freed = self.src_pool.release(self._srcs.pop(state.rid), owner=state.rid)
                if freed is not None:
                    self.cache = self.model.release_source(self.cache, freed)
                    self.dispatches += 1
            if self._sink is not None:
                self._sink("release", t=now, rid=state.rid, slot=slot,
                           serial=int(self.serial[slot]))
            self.active[slot] = False
            self.tok[slot] = self.pad_id
            self.budget[slot] = 0
            self._note_service(state, now)
        else:
            self.active[state.slot] = True
            self.tok[state.slot] = token
            self.emitted[state.slot] = len(state.tokens)

    # ---- drive a whole trace ----------------------------------------------
    def run(self, requests: list[Request] | None = None) -> dict:
        """Drive until every request retires. A request is submitted once
        the wall clock passes its ``arrival`` (0.0 everywhere: a backlogged
        throughput run); an idle engine sleeps until the next arrival.

        ``drain()`` ends the run early but cleanly: queued and not-yet-due
        requests shed with code ``drain``, in-flight ones finish. A
        ``KeyboardInterrupt`` is the abrupt form: it is caught at the loop
        boundary, queued and waiting requests shed, slot holders retire
        with their partial tokens (code ``interrupt``) through a host-only
        reclaim, telemetry flushes, and the report says ``interrupted``."""
        self.sched.reset_stats()
        self.pool.reset_stats()
        if self.src_pool is not None:
            self.src_pool.reset_stats()
        self._zero_counters()
        self.hist_ttft.reset()
        self.hist_itl.reset()
        self._shed_seen = 0
        self._draining = False
        self._interrupted = False
        self._cancels.clear()
        self.dispatch_retries = 0
        if self.auditor is not None:
            self.auditor.reset()
        if self.tel is not None:
            self.tel.reset()            # the stream covers this run only
        waiting = sorted(requests or [], key=lambda r: r.arrival)
        self._t0 = t0 = time.perf_counter()
        try:
            while True:
                now = time.perf_counter() - t0
                if self._draining:
                    # not-yet-due arrivals submit now and shed (a typed
                    # terminal state, nothing dropped silently)
                    for r in waiting:
                        self.submit(r, now=now)
                    waiting = []
                while waiting and waiting[0].arrival <= now:
                    self.submit(waiting.pop(0), now=now)
                # a not-yet-due arrival with a free slot waiting for it caps
                # the tick horizon
                deadline = (waiting[0].arrival
                            if waiting and self.pool.n_free else None)
                worked = self.step(now, deadline)
                if not worked and not waiting:
                    break
                if not worked:
                    time.sleep(max(0.0, waiting[0].arrival
                                   - (time.perf_counter() - t0)))
        except KeyboardInterrupt:
            now = time.perf_counter() - t0
            self._interrupted = True
            self._draining = True
            for r in waiting:
                self.submit(r, now=now)
            waiting = []
            for st in list(self.sched.queue):
                self.sched.shed_queued(st, "interrupt", now, detail="shed: run interrupted")
            for st in list(self.sched.prefilling) + list(self.sched.decoding.values()):
                self._reclaim(st, "interrupt", now, device=False,
                              detail="interrupted with partial tokens")
            self._sync_shed_serials()
        wall = time.perf_counter() - t0
        self.sched.assert_conservation()
        if self.src_pool is not None:
            self.src_pool.assert_consistent()
            assert self.src_pool.n_used <= self.pool.n_used, \
                "source entries outlive their holders"
        if self.tel is not None:
            self.tel.flush()            # no lost JSONL tail on drain or interrupt
        return self.report(wall)

    def report(self, wall_s: float) -> dict:
        done = self.sched.retired
        gen = sum(len(s.tokens) for s in done)

        def _h(hist, q, scale=1.0):
            p = hist.percentile(q)
            return None if p is None else round(scale * p, 4)
        # KV bytes per slot: the self KV planes and the source K/V (per-row
        # or pooled; with n_sources == n_slots the per-slot share is exact)
        kv = [self.cache[k] for k in _KV_KEYS if k in self.cache]
        kv_bytes = sum(a.numel() * a.element_size() for a in kv)
        term = self.sched.retired + self.sched.shed + self.sched.errored
        agg = {
            "n_requests": self.sched.n_submitted,
            "n_retired": self.sched.n_retired,
            "n_rejected": len(self.sched.rejected),
            "n_shed": len(self.sched.shed),
            "n_errored": len(self.sched.errored),
            "n_deadline_missed": sum(s.code == "deadline" for s in term),
            "n_cancelled": sum(s.code == "cancelled" for s in term),
            "generated_tokens": gen,
            "wall_s": round(wall_s, 3),
            "tokens_per_s": round(gen / wall_s, 1) if wall_s else None,
            "decode_ticks": self.max_ticks,
            "decode_steps": self.decode_steps,
            "decode_dispatches": self.decode_dispatches,
            "decode_ticks_run": self.decode_ticks_run,
            "prefill_chunks": self.prefill_chunks,
            "prefill_dispatches": self.prefill_dispatches,
            "dispatches": self.dispatches,
            "host_syncs": self.host_syncs,
            "dispatches_per_token": (round(self.dispatches / gen, 4)
                                     if gen else None),
            "issued_ticks": self.issued_ticks,
            "parked_ticks": self.parked_ticks,
            "mean_occupancy": round(
                self.active_row_steps
                / (self.decode_steps * self.pool.n_slots), 3)
                if self.decode_steps else 0.0,
            "kv_bytes_per_slot": kv_bytes // self.pool.n_slots,
            "kv_rows_per_slot": (int(self.cache["k"].shape[2])
                                 if "k" in self.cache else 0),   # RWKV6: no KV
            "max_len": self.pool.max_len,
            "ttft_p50_s": _h(self.hist_ttft, 0.50),
            "ttft_p95_s": _h(self.hist_ttft, 0.95),
            "ttft_p99_s": _h(self.hist_ttft, 0.99),
            "itl_p50_ms": _h(self.hist_itl, 0.50, scale=1e3),
            "itl_p95_ms": _h(self.hist_itl, 0.95, scale=1e3),
            "itl_source": "subdivided" if self.max_ticks > 1 else "exact",
            "itl_effective_ms": (round(1e3 * wall_s / gen, 4)
                                 if gen else None),
        }
        if self.tel is not None:
            agg["telemetry_events"] = len(self.tel.events)
        if self.sched.n_degraded:
            agg["n_degraded"] = self.sched.n_degraded
        if self.faults is not None:
            agg["faults_fired"] = self.faults.n_fired
            agg["faults_pending"] = self.faults.n_pending
            agg["dispatch_retries"] = self.dispatch_retries
        if self.auditor is not None:
            agg["audit_checks"] = self.auditor.n_checks
        if self._draining:
            agg["drained"] = True
        if self._interrupted:
            agg["interrupted"] = True
        if self.src_pool is not None:
            # ingests ran the encoder / cross projections; shares were
            # served by refcount alone
            agg["source_ingests"] = self.src_pool.total_ingests
            agg["source_shares"] = self.src_pool.total_shares
            agg["src_rows_per_entry"] = self.src_pool.src_max
        return {
            "requests": [{
                "rid": s.rid, "prompt_len": int(len(s.request.prompt)),
                "n_tokens": len(s.tokens), "tokens": list(s.tokens),
                "ttft_s": None if s.ttft is None else round(s.ttft, 4),
                "finish_reason": s.finish_reason,
                "status": s.status, "code": s.code,
            } for s in (done + self.sched.errored + self.sched.rejected
                        + self.sched.shed)],
            "aggregate": agg,
        }
