"""Deterministic fault injection for the continuous serving engine. Port of
``repro.serving.faults`` (numpy and the standard library only): one seed
gives the same plan in both packages.

A :class:`FaultPlan` is a seeded, replayable list of :class:`Fault`\\ s the
engine consults at its four failure seams:

======================  =====================================================
kind                    injected where / recovery contract
======================  =====================================================
``poison_nan``          the victim request's logits row is overwritten with
                        NaN inside the decode block (``decode_multi``'s
                        ``poison`` mask). The on-device finite check turns
                        the row into the ``-2`` quarantine sentinel on the
                        existing ``[K, n_slots]`` sync; the engine retires
                        *only* that request as ERRORED
                        (``nonfinite_logits``), reclaims its slot + source
                        reference, and every other stream stays
                        byte-identical.
``ingest_fail``         the victim's source-KV ingest fails at admission:
                        the request is retired as ERRORED
                        (``source_ingest_failed``) before any device write,
                        its slot returned to the free list the same step.
``dispatch_fail``       a decode-block dispatch raises *before* the model
                        call (so the cache was never touched and the retry
                        re-dispatches safely); the engine counts the retry
                        and proceeds — tokens are unaffected.
``tick_delay``          the engine sleeps ``delay_s`` before a decode
                        dispatch — a stall, not an error; exercises the
                        timing-robustness of deadline bookkeeping.
======================  =====================================================

Determinism: a plan is pure data — no clocks, no global RNG. ``poison_nan``
and ``ingest_fail`` target a request id and (for poison) an emitted-token
threshold, both properties of the *request*, not of wall time, so the same
plan over the same trace fires at the same request-relative point on every
run; :meth:`FaultPlan.replay` returns a fresh unfired copy for exact-replay
assertions. :meth:`FaultPlan.random` derives a plan from a seed via
``numpy``'s deterministic generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

FAULT_KINDS = ("poison_nan", "ingest_fail", "dispatch_fail", "tick_delay")


class FaultInjected(RuntimeError):
    """Raised at a seam when a matching fault fires (``dispatch_fail``
    raises it for real so the engine's retry path is a genuine
    try/except)."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected fault: {fault.kind} "
                         f"(rid={fault.rid!r}, block>={fault.block})")
        self.fault = fault


@dataclass(eq=False)
class Fault:
    """One injected failure. ``rid`` targets a request (``poison_nan`` /
    ``ingest_fail``); ``block`` is the earliest decode-dispatch index the
    fault may fire at (engine-global counter); ``after_tokens`` gates
    ``poison_nan`` on the victim having emitted at least that many tokens
    (>= 1 is always true once decoding — the prefill first token — so the
    default fires at the victim's first decode block, making the fired
    point a request-relative, replay-deterministic event even under timed
    arrivals); ``delay_s`` is the ``tick_delay`` stall."""
    kind: str
    rid: object = None
    block: int = 0
    after_tokens: int = 1
    delay_s: float = 0.0
    fired: bool = field(default=False, compare=False)
    fired_block: int | None = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {FAULT_KINDS})")
        if self.kind in ("poison_nan", "ingest_fail") and self.rid is None:
            raise ValueError(f"{self.kind} requires a target rid")
        if self.block < 0 or self.after_tokens < 0 or self.delay_s < 0:
            raise ValueError("block / after_tokens / delay_s must be >= 0")

    def to_json(self) -> dict:
        out = {"kind": self.kind, "block": self.block, "fired": self.fired}
        if self.rid is not None:
            out["rid"] = self.rid
        if self.kind == "poison_nan":
            out["after_tokens"] = self.after_tokens
        if self.kind == "tick_delay":
            out["delay_s"] = self.delay_s
        if self.fired_block is not None:
            out["fired_block"] = self.fired_block
        return out


class FaultPlan:
    """An ordered set of faults plus fired-state bookkeeping. Engines call
    the ``take_*`` methods at their seams; each fault fires at most once."""

    def __init__(self, faults: list[Fault], seed: int | None = None):
        self.faults = list(faults)
        self.seed = seed

    # ---- construction ------------------------------------------------------
    @classmethod
    def random(cls, seed: int, rids: list, *, n_faults: int = 3,
               kinds: tuple = ("poison_nan", "dispatch_fail", "tick_delay"),
               max_block: int = 3) -> "FaultPlan":
        """Deterministic plan from a seed: ``n_faults`` draws of kind /
        victim / firing block. ``ingest_fail`` must be opted into via
        ``kinds`` (it only makes sense on source-bearing configs). Distinct
        victims per targeted fault, so expected-errored sets are exact."""
        if not rids:
            raise ValueError("need at least one candidate rid")
        rng = np.random.default_rng(seed)
        pool = list(rids)
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(kinds))
            if kind in ("poison_nan", "ingest_fail"):
                if not pool:
                    kind = "dispatch_fail"   # victims exhausted: benign kind
                else:
                    victim = pool.pop(int(rng.integers(len(pool))))
                    faults.append(Fault(kind, rid=victim,
                                        block=int(rng.integers(max_block + 1))
                                        if kind == "poison_nan" else 0))
                    continue
            if kind == "tick_delay":
                faults.append(Fault(kind,
                                    block=int(rng.integers(max_block + 1)),
                                    delay_s=float(rng.uniform(5e-4, 2e-3))))
            else:
                faults.append(Fault(kind,
                                    block=int(rng.integers(max_block + 1))))
        return cls(faults, seed=seed)

    def replay(self) -> "FaultPlan":
        """A fresh, unfired copy of the same plan — run it over the same
        trace and every fault fires at the same request-relative point."""
        return FaultPlan([replace(f, fired=False, fired_block=None)
                          for f in self.faults], seed=self.seed)

    # ---- seam queries (each fault fires at most once) ----------------------
    def take_ingest(self, rid) -> Fault | None:
        """First unfired ``ingest_fail`` targeting ``rid``, marked fired."""
        for f in self.faults:
            if f.kind == "ingest_fail" and not f.fired and f.rid == rid:
                f.fired = True
                return f
        return None

    def take_poison(self, candidates: dict, block: int) -> list:
        """``candidates``: ``{rid: emitted_tokens}`` for the rows decoding
        in the block about to dispatch. Returns the rids to NaN-poison this
        block (matching unfired faults marked fired)."""
        hit = []
        for f in self.faults:
            if (f.kind == "poison_nan" and not f.fired
                    and f.rid in candidates and block >= f.block
                    and candidates[f.rid] >= f.after_tokens):
                f.fired = True
                f.fired_block = block
                hit.append(f.rid)
        return hit

    def take(self, kind: str, *, block: int) -> Fault | None:
        """First unfired untargeted fault of ``kind`` whose firing block
        has been reached, marked fired (``dispatch_fail`` /
        ``tick_delay``)."""
        for f in self.faults:
            if f.kind == kind and not f.fired and block >= f.block:
                f.fired = True
                f.fired_block = block
                return f
        return None

    def raise_if(self, kind: str, *, block: int) -> None:
        """Raise :class:`FaultInjected` when a matching fault fires — the
        ``dispatch_fail`` seam, called *before* the decode dispatch so the
        cache is untouched and the engine's retry is safe."""
        f = self.take(kind, block=block)
        if f is not None:
            raise FaultInjected(f)

    # ---- queries -----------------------------------------------------------
    @property
    def n_fired(self) -> int:
        return sum(f.fired for f in self.faults)

    @property
    def n_pending(self) -> int:
        return sum(not f.fired for f in self.faults)

    def fired(self, kind: str | None = None) -> list[Fault]:
        return [f for f in self.faults
                if f.fired and (kind is None or f.kind == kind)]

    def victims(self) -> list:
        """rids of fired *targeted* faults — the exact set of requests a
        clean recovery must (and must only) retire as errored."""
        return [f.rid for f in self.faults
                if f.fired and f.kind in ("poison_nan", "ingest_fail")]

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_json() for f in self.faults]}

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, n={len(self.faults)}, "
                f"fired={self.n_fired})")
