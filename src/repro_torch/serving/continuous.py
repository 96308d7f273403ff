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

Not ported yet: telemetry events, overload control, fault injection and
the invariant auditor (ROADMAP §1 item 6); passing any of them raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.quantized import quantize_params

from repro_torch.models.api import needs_source

from .scheduler import Request, RequestState, Scheduler
from .slot_pool import KVSlotPool, SourceKVPool
from .telemetry import LogHistogram

_KV_KEYS = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v", "src_k", "src_v",
            "src_k_scale", "src_v_scale")


class ContinuousBatchingEngine:
    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 chunk: int = 16, eos_id: int | None = None,
                 pad_id: int = 0, temperature: float = 0.0, seed: int = 0,
                 decode_ticks: int = 1, source_len: int | None = None,
                 telemetry=None, overload=None, faults=None, auditor=None):
        deferred = {"telemetry": telemetry, "overload": overload, "faults": faults,
                    "auditor": auditor}
        for name, value in deferred.items():
            if value is not None:
                raise NotImplementedError(
                    f"ContinuousBatchingEngine: {name}= is not ported yet "
                    "(ROADMAP §1 item 6; cancel, drain, deadlines and "
                    "quarantine go with it)")
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
        self.pool = KVSlotPool(n_slots, max_len)
        self.sched = Scheduler(self.pool)
        # sampler keys: (seed, admission serial, token index)
        self._base_key = prng.prng_key(seed, device=self.device)
        cfg = model.cfg
        # cross-attention models: the source-KV pool, one entry per slot, so
        # an entry is free whenever a slot is
        self.needs_source = needs_source(cfg)
        self.src_pool = None
        if self.needs_source:
            self.src_max = source_len or cfg.source_len
            self.src_pool = SourceKVPool(n_slots, self.src_max)
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
        reject = None
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
        state = self.sched.submit(request, now, reject=reject)
        if state.status == "queued":
            # admission is FIFO over submission, so the serial is a
            # property of the trace
            self._serials[state.rid] = self._serial_ctr
            self._serial_ctr += 1
        return state

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
        self.run([Request(prompt=np.zeros(p, np.int32), max_new_tokens=m,
                          rid="__warmup__", source=src)])
        return self

    # ---- horizon -----------------------------------------------------------
    def _tick_horizon(self, now: float | None = None,
                      deadline: float | None = None) -> int:
        """K = min(decode_ticks, min remaining budget among active rows),
        1 while prefill chunks wait, capped so that the block ends by
        ``deadline`` (the next timed arrival while a slot is free, from the
        per-tick EWMA), floored to a power of two."""
        if self.max_ticks == 1 or self.sched.prefilling:
            return 1
        rem = min(s.remaining for s in self.sched.decoding.values())
        k = max(1, min(self.max_ticks, rem))
        if deadline is not None and now is not None and self._tick_s > 0:
            k = max(1, min(k, int((deadline - now) / self._tick_s)))
        return 1 << (k.bit_length() - 1)

    # ---- one engine step --------------------------------------------------
    @torch.no_grad()
    def step(self, now: float | None = None,
             deadline: float | None = None) -> bool:
        """Admit, advance every prefilling slot one chunk, run one K-tick
        decode block. Returns False when nothing was left to do."""
        now = (time.perf_counter() - self._t0) if now is None else now
        newly = self.sched.admit(now)
        if self.needs_source:
            # ingest at admission, before the request's first chunk: the
            # chunk's cross reads need the entry resident
            for st in newly:
                self._acquire_source(st)
        if self.sched.prefilling:
            self._advance_prefills()
        if not self.active.any():
            return self.sched.pending()

        k = self._tick_horizon(now, deadline)
        live_slots = np.flatnonzero(self.active)
        t_dispatch = time.perf_counter()
        toks, _, _, self.cache = self.model.decode_multi(
            self.params, self._to_device(self.tok), self.cache,
            self._to_device(self.active), self._to_device(self.budget),
            self._to_device(self.serial), self._to_device(self.emitted), k,
            eos_id=self.eos_id, temperature=self.temperature,
            base_key=self._base_key)
        self.decode_dispatches += 1
        self.decode_ticks_run += k
        self.dispatches += 1
        rows = toks.cpu().numpy()                # [K, n_slots]; the one sync
        self.host_syncs += 1
        # the block's tokens all arrive at this sync: stamps inside the
        # block are attributed by even subdivision of its wall span
        now_blk = time.perf_counter() - self._t0
        blk_start = t_dispatch - self._t0
        per_tick = (now_blk - blk_start) / k
        self._tick_s = (per_tick if self._tick_s == 0.0
                        else 0.5 * self._tick_s + 0.5 * per_tick)
        emitted_blk = 0
        for t in range(k):
            if (rows[t] == -2).any():
                slot = int(np.flatnonzero(rows[t] == -2)[0])
                raise RuntimeError(
                    f"non-finite logits in slot {slot} (request "
                    f"{self.sched.decoding[slot].rid!r}); quarantine is not "
                    "ported yet (ROADMAP §1 item 6)")
            live = rows[t] >= 0                  # -1 marks parked rows
            if not live.any():
                break                            # every row retired mid-block
            stamp = blk_start + (t + 1) * per_tick
            self.decode_steps += 1
            self.active_row_steps += int(live.sum())
            emitted_blk += int(live.sum())
            for slot in np.flatnonzero(live):
                state = self.sched.decoding[int(slot)]
                self.pool.advance(int(slot))
                self._emit(state, int(rows[t, slot]), stamp)
        issued = k * len(live_slots)
        self.issued_ticks += issued
        self.parked_ticks += issued - emitted_blk
        return True

    def _acquire_source(self, st: RequestState) -> None:
        """A newly admitted request's pool entry: the resident entry of its
        source id (shared, no ingest) or a fresh one, ingested once from
        the source padded to the pool's rows; then the slot points at it.
        A request without a source takes a fresh entry and ingests nothing
        (the entry is zero, ``src_len`` 0)."""
        req = st.request
        sid = req.source_id if req.source_id is not None else ("__rid__", st.rid)
        entry, fresh = self.src_pool.acquire(sid)
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
        for i, st in enumerate(states):
            prompt = st.request.prompt
            off = st.prefilled
            part = prompt[off:off + self.chunk]
            toks[i, :part.size] = part
            slots[i], offs[i] = st.slot, off
            lasts[i] = min(self.chunk - 1, max(0, len(prompt) - 1 - off))
            valid[i] = True
        logits, self.cache = self.model.prefill_chunks_batched(
            self.params, self._to_device(toks), self.cache, slots, offs, lasts,
            valid)
        self.prefill_dispatches += 1
        self.dispatches += 1
        self.prefill_chunks += len(states)
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
            self._emit(st, tok0, time.perf_counter() - self._t0)

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
            slot = self.sched.retire(state, "eos" if done else "max_tokens", now)
            self.cache = self.model.release_slot(self.cache, slot)
            self.dispatches += 1
            if self.needs_source:
                # drop the source reference; zero the entry only when this
                # was its last holder
                freed = self.src_pool.release(self._srcs.pop(state.rid))
                if freed is not None:
                    self.cache = self.model.release_source(self.cache, freed)
                    self.dispatches += 1
            self.active[slot] = False
            self.tok[slot] = self.pad_id
            self.budget[slot] = 0
        else:
            self.active[state.slot] = True
            self.tok[state.slot] = token
            self.emitted[state.slot] = len(state.tokens)

    # ---- drive a whole trace ----------------------------------------------
    def run(self, requests: list[Request] | None = None) -> dict:
        """Drive until every request retires. A request is submitted once
        the wall clock passes its ``arrival`` (0.0 everywhere: a backlogged
        throughput run); an idle engine sleeps until the next arrival."""
        self.sched.reset_stats()
        self.pool.reset_stats()
        if self.src_pool is not None:
            self.src_pool.reset_stats()
        self._zero_counters()
        self.hist_ttft.reset()
        self.hist_itl.reset()
        waiting = sorted(requests or [], key=lambda r: r.arrival)
        self._t0 = t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
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
        wall = time.perf_counter() - t0
        self.sched.assert_conservation()
        if self.src_pool is not None:
            self.src_pool.assert_consistent()
            assert self.src_pool.n_used <= self.pool.n_used, \
                "source entries outlive their holders"
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
        agg = {
            "n_requests": self.sched.n_submitted,
            "n_retired": self.sched.n_retired,
            "n_rejected": len(self.sched.rejected),
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
            } for s in done + self.sched.rejected],
            "aggregate": agg,
        }
