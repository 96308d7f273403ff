"""Engine invariant auditor: cross-layer consistency checks for the
continuous batching engine, run after every decode block (or every
``every``-th) when enabled — and costing *nothing* when not, exactly like
telemetry: the engine holds ``auditor=None`` by default and the single call
site is guarded, so the disabled path is the unchanged host loop. Port of
``repro.serving.audit`` (numpy only), check for check.

The scheduler, the slot pool, the source pool, and the engine's device-
mirrored arrays (``active`` / ``tok`` / ``budget`` / ``emitted``) each keep
their own view of "who is running"; a robustness bug (leaked slot, stale
active bit, refcount drift, ledger length skew) shows up as those views
disagreeing long before it corrupts tokens. :class:`EngineAuditor.check`
asserts the full cross-ledger contract:

* **free-list consistency** — ``KVSlotPool.assert_consistent`` (no slot
  both free and owned, alloc/release conservation, freed slots at length
  0), plus slot-owner agreement: the pool's ``slot -> owner`` map names
  exactly the scheduler's prefilling + decoding rids.
* **source-pool refcount conservation** — ``SourceKVPool.assert_consistent``
  plus ``total_refs() == len(engine._srcs)`` (every live reference is held
  by exactly one in-flight request) and ``n_used <= pool.n_used`` (entries
  never outlive their holders).
* **active-mask / parked-write contract** — ``active``'s true rows are
  exactly the scheduler's decoding slots; an active row's ``budget`` is its
  request's ``max_new_tokens``, its ``emitted`` its token count, its ``tok``
  its last token; a *free* slot's ``tok`` is ``pad_id`` and ``budget`` 0,
  so a stale row could never decode as live.
* **KV length ledger** — a decoding slot's pool length equals
  ``prompt_len + tokens - 1`` (the first token is sampled off prefill
  logits and writes no KV row; every later token advanced the ledger), and
  a prefilling slot's equals its committed chunk prefix.
* **request conservation** — ``Scheduler.assert_conservation`` (every
  submitted request in exactly one terminal/live bucket, typed codes on
  every terminal record, admitted == decoding + prefilling + retired +
  errored).

Violations raise :class:`AuditViolation` immediately (subclass of
``AssertionError``: a failed audit is a bug in the engine, not an operating
condition), carrying the failed invariant's name.
"""
from __future__ import annotations

import numpy as np


class AuditViolation(AssertionError):
    """An engine invariant does not hold. ``invariant`` names the check."""

    def __init__(self, invariant: str, detail: str):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant


class EngineAuditor:
    """``every``: audit each ``every``-th decode block (1 = every block).
    ``n_checks`` counts completed full audits — a chaos run asserting
    recovery must also assert this is > 0, or the audit never ran."""

    def __init__(self, every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = every
        self.n_checks = 0
        self._calls = 0

    def reset(self) -> None:
        """Zero the counters (the engine calls this at each ``run()`` entry
        so ``audit_checks`` in the report covers that run only)."""
        self.n_checks = 0
        self._calls = 0

    def maybe_check(self, engine) -> bool:
        """Rate-limited entry point the engine calls per block."""
        self._calls += 1
        if self._calls % self.every:
            return False
        self.check(engine)
        return True

    def check(self, engine) -> None:
        self._pools(engine)
        self._active_contract(engine)
        self._length_ledger(engine)
        try:
            engine.sched.assert_conservation()
        except AssertionError as e:
            raise AuditViolation("request_conservation", str(e)) from e
        self.n_checks += 1

    # ---- individual invariant groups --------------------------------------
    def _pools(self, engine) -> None:
        try:
            engine.pool.assert_consistent()
        except AssertionError as e:
            raise AuditViolation("free_list", str(e)) from e
        sched = engine.sched
        holders = {st.slot: st.rid for st in sched.prefilling}
        holders.update({slot: st.rid for slot, st in sched.decoding.items()})
        owners = engine.pool.used_slots()
        if owners != holders:
            raise AuditViolation(
                "slot_owners",
                f"pool owners {owners} != scheduler holders {holders}")
        if engine.src_pool is not None:
            try:
                engine.src_pool.assert_consistent()
            except AssertionError as e:
                raise AuditViolation("source_pool", str(e)) from e
            refs, held = engine.src_pool.total_refs(), len(engine._srcs)
            if refs != held:
                raise AuditViolation(
                    "source_refcounts",
                    f"{refs} live references vs {held} holding requests")
            if engine.src_pool.n_used > engine.pool.n_used:
                raise AuditViolation(
                    "source_refcounts",
                    f"{engine.src_pool.n_used} source entries in use with "
                    f"only {engine.pool.n_used} slots held")

    def _active_contract(self, engine) -> None:
        sched = engine.sched
        active = set(int(s) for s in np.flatnonzero(engine.active))
        decoding = set(sched.decoding)
        if active != decoding:
            raise AuditViolation(
                "active_mask",
                f"active rows {sorted(active)} != decoding slots "
                f"{sorted(decoding)}")
        for slot, st in sched.decoding.items():
            want = st.request.max_new_tokens
            if int(engine.budget[slot]) != want:
                raise AuditViolation(
                    "active_mask",
                    f"slot {slot} ({st.rid!r}): budget "
                    f"{int(engine.budget[slot])} != max_new_tokens {want}")
            if int(engine.emitted[slot]) != len(st.tokens):
                raise AuditViolation(
                    "active_mask",
                    f"slot {slot} ({st.rid!r}): emitted "
                    f"{int(engine.emitted[slot])} != {len(st.tokens)} tokens")
            if st.tokens and int(engine.tok[slot]) != st.tokens[-1]:
                raise AuditViolation(
                    "active_mask",
                    f"slot {slot} ({st.rid!r}): tok {int(engine.tok[slot])} "
                    f"!= last token {st.tokens[-1]}")
        held = decoding | {st.slot for st in sched.prefilling}
        for slot in range(engine.pool.n_slots):
            if slot in held:
                continue
            if int(engine.tok[slot]) != engine.pad_id:
                raise AuditViolation(
                    "parked_write",
                    f"free slot {slot} keeps tok {int(engine.tok[slot])} "
                    f"(pad_id {engine.pad_id})")
            if int(engine.budget[slot]) != 0:
                raise AuditViolation(
                    "parked_write",
                    f"free slot {slot} keeps budget "
                    f"{int(engine.budget[slot])}")

    def _length_ledger(self, engine) -> None:
        for slot, st in engine.sched.decoding.items():
            want = len(st.request.prompt) + max(0, len(st.tokens) - 1)
            got = engine.pool.length(slot)
            if got != want:
                raise AuditViolation(
                    "length_ledger",
                    f"slot {slot} ({st.rid!r}): ledger length {got} != "
                    f"prompt {len(st.request.prompt)} + "
                    f"{len(st.tokens)} tokens - 1 = {want}")
        for st in engine.sched.prefilling:
            got = engine.pool.length(st.slot)
            if got != 0:
                # set_length happens at start_decoding; mid-prefill slots
                # stay at 0 (chunk progress lives in state.prefilled)
                raise AuditViolation(
                    "length_ledger",
                    f"prefilling slot {st.slot} ({st.rid!r}) has ledger "
                    f"length {got} before start_decoding")
