"""KV slot pool and source-KV pool: the host-side ledgers of continuous
batching. Port of ``repro.serving.slot_pool`` (``KVSlotPool``,
``SourceKVPool`` with its telemetry sink).

Continuous batching keeps the decode step at a static ``[n_slots]`` batch
shape while request membership changes every step. :class:`KVSlotPool` is
the ledger over the model's preallocated decode cache
(``model.init_cache(n_slots, max_len)``): slot ``s`` owns rows
``cache[k|v][:, s, :]`` plus its entries of ``cache['len']`` and the RoPE
angle state.

Layout contract with :meth:`TransformerLM.decode_step`'s ragged form:

* the **final cache row** (index ``max_len - 1``) is reserved as the parking
  position for the discarded KV writes of inactive slots, so a request is
  only admissible if ``prompt_len + max_new_tokens - 1 <= capacity`` where
  ``capacity = max_len - 1``. Ring KV caches (``+ring`` sliding-window
  configs) have no parkable dead row — every ring slot is, or wraps into,
  a live window position — so their inactive slots park through a per-row
  **write mask** (the row rewrites its old value in place;
  ``TransformerLM.decode_step``'s ragged form). The tail reservation still
  prices admission for rings: ``capacity`` bounds a request's *position*
  budget (``cache['len']`` and the RoPE state run over absolute
  positions), which scales with ``max_len`` even when the live KV working
  set is only ``ring_len`` rows;
* release resets the slot's ledger length (and the device ``len`` entry via
  :meth:`TransformerLM.release_slot`), so nothing in a freed slot's KV rows
  is attended again — the next occupant's chunked prefill overwrites the
  contents in place (reset-on-release).
"""
from __future__ import annotations

from typing import Hashable

RESERVED_TAIL = 1   # parking row for the discarded decode writes of inactive slots


class SlotPoolError(RuntimeError):
    """Misuse of the pool (double release, unknown slot, ...)."""


class KVSlotPool:
    def __init__(self, n_slots: int, max_len: int):
        if n_slots < 1:
            raise SlotPoolError(f"n_slots must be >= 1, got {n_slots}")
        if max_len <= RESERVED_TAIL:
            raise SlotPoolError(f"max_len must exceed {RESERVED_TAIL}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.capacity = max_len - RESERVED_TAIL
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> slot 0 first
        self._owner: dict[int, Hashable] = {}
        self._length = [0] * n_slots
        self.total_allocs = 0
        self.total_releases = 0

    # ---- queries ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    def fits(self, tokens: int) -> bool:
        """Can a request needing ``tokens`` cache rows ever be admitted?"""
        return 0 < tokens <= self.capacity

    def owner(self, slot: int) -> Hashable:
        return self._owner.get(slot)

    def length(self, slot: int) -> int:
        return self._length[slot]

    def used_slots(self) -> dict[int, Hashable]:
        """Snapshot of ``slot -> owner`` for every allocated slot (the
        auditor cross-checks this against the scheduler's view)."""
        return dict(self._owner)

    def occupancy(self) -> float:
        return self.n_used / self.n_slots

    # ---- alloc / release --------------------------------------------------
    def alloc(self, owner: Hashable) -> int | None:
        """Take a slot off the free list for ``owner``; None when exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = owner
        self._length[slot] = 0
        self.total_allocs += 1
        return slot

    def release(self, slot: int) -> Hashable:
        """Return a slot to the free list (reset-on-release). The caller is
        responsible for the matching device-side reset
        (:meth:`TransformerLM.release_slot`)."""
        if slot not in self._owner:
            raise SlotPoolError(f"release of unowned slot {slot}")
        owner = self._owner.pop(slot)
        self._length[slot] = 0
        self._free.append(slot)
        self.total_releases += 1
        return owner

    def set_length(self, slot: int, length: int) -> None:
        if slot not in self._owner:
            raise SlotPoolError(f"set_length on unowned slot {slot}")
        if not 0 <= length <= self.capacity:
            raise SlotPoolError(f"length {length} outside [0, {self.capacity}]")
        self._length[slot] = length

    def advance(self, slot: int) -> int:
        """One decode step appended one KV row for this slot."""
        self.set_length(slot, self._length[slot] + 1)
        return self._length[slot]

    def reset_stats(self) -> None:
        """Zero the lifetime counters without touching allocation state
        (keeps ``total_allocs - total_releases == slots in use``)."""
        self.total_allocs = len(self._owner)
        self.total_releases = 0

    # ---- invariants -------------------------------------------------------
    def assert_consistent(self) -> None:
        assert len(self._free) + len(self._owner) == self.n_slots, \
            (self._free, self._owner)
        assert len(set(self._free)) == len(self._free), "free-list duplicates"
        assert not (set(self._free) & set(self._owner)), "slot both free+owned"
        assert self.total_allocs - self.total_releases == len(self._owner)
        for slot in self._free:
            assert self._length[slot] == 0, f"freed slot {slot} keeps length"


class SourceKVPool:
    """Refcounted pool of source (encoder-side) K/V entries, keyed by
    source id: the ledger over the cache's ``src_k`` / ``src_v`` [:, e],
    ``src_len[e]`` of a cross-attention model.

    ``acquire(source_id)`` bumps the refcount of an entry already holding
    that source (the requests share one ingest) or takes a fresh entry off
    the free list; ``release`` drops a reference and returns the entry for
    zeroing (``TransformerLM.release_source``) only when its last holder
    retired. With ``n_entries == n_slots`` (the engine's pool) acquisition
    cannot fail while a slot is free: each live request holds at most one
    reference.

    ``on_event``: optional telemetry sink (``sink(kind, **data)``) called at
    the ledger's three state changes: ``source_ingest`` (fresh entry, the
    caller runs the encoder), ``source_share`` (served by refcount) and
    ``source_release`` (last holder gone, the entry goes back for zeroing),
    each with the source id, entry, refcount and the ``owner`` the caller
    passes (the request id)."""

    def __init__(self, n_entries: int, src_max: int, on_event=None):
        if n_entries < 1:
            raise SlotPoolError(f"n_entries must be >= 1, got {n_entries}")
        if src_max < 1:
            raise SlotPoolError(f"src_max must be >= 1, got {src_max}")
        self.n_entries = n_entries
        self.src_max = src_max              # rows per entry (pad-to length)
        self._free = list(range(n_entries - 1, -1, -1))   # pop() -> entry 0
        self._entry: dict[Hashable, int] = {}             # source id -> entry
        self._refs: dict[int, int] = {}                   # entry -> refcount
        self._sid: dict[int, Hashable] = {}               # entry -> source id
        self._sink = on_event               # telemetry sink; None -> silent
        self.total_ingests = 0              # fresh entries (the encoder ran)
        self.total_shares = 0               # acquisitions served by sharing

    # ---- queries ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_entries - len(self._free)

    def fits(self, source_rows: int) -> bool:
        """Can a source of ``source_rows`` K/V rows ever be ingested? (Zero
        rows, a request without a source, always fits: its entry's
        ``src_len`` stays 0.)"""
        return 0 <= source_rows <= self.src_max

    def entry_of(self, source_id: Hashable) -> int | None:
        return self._entry.get(source_id)

    def refcount(self, entry: int) -> int:
        return self._refs.get(entry, 0)

    def total_refs(self) -> int:
        """Live references across all entries: the number of requests
        holding a source (the auditor checks it against the engine's
        rid -> source-id ledger)."""
        return sum(self._refs.values())

    # ---- acquire / release ------------------------------------------------
    def acquire(self, source_id: Hashable,
                owner: Hashable = None) -> tuple[int | None, bool]:
        """``(entry, fresh)``: ``fresh`` means the caller must ingest the
        source into the entry; else the source is resident and shared.
        ``(None, False)`` when the pool is exhausted. ``owner`` (the request
        id) rides on the ledger's telemetry events."""
        entry = self._entry.get(source_id)
        if entry is not None:
            self._refs[entry] += 1
            self.total_shares += 1
            if self._sink is not None:
                self._sink("source_share", rid=owner, entry=entry,
                           source_id=source_id, refcount=self._refs[entry])
            return entry, False
        if not self._free:
            return None, False
        entry = self._free.pop()
        self._entry[source_id] = entry
        self._refs[entry] = 1
        self._sid[entry] = source_id
        self.total_ingests += 1
        if self._sink is not None:
            self._sink("source_ingest", rid=owner, entry=entry,
                       source_id=source_id, refcount=1)
        return entry, True

    def release(self, source_id: Hashable,
                owner: Hashable = None) -> int | None:
        """Drop one reference; the freed entry when it was the last (the
        caller then zeroes its device rows), else None."""
        entry = self._entry.get(source_id)
        if entry is None:
            raise SlotPoolError(f"release of unknown source id {source_id!r}")
        self._refs[entry] -= 1
        if self._refs[entry] > 0:
            return None
        del self._refs[entry]
        del self._entry[source_id]
        del self._sid[entry]
        self._free.append(entry)
        if self._sink is not None:
            self._sink("source_release", rid=owner, entry=entry,
                       source_id=source_id, refcount=0)
        return entry

    def reset_stats(self) -> None:
        self.total_ingests = len(self._entry)
        self.total_shares = 0

    # ---- invariants -------------------------------------------------------
    def assert_consistent(self) -> None:
        assert len(self._free) + len(self._entry) == self.n_entries, \
            (self._free, self._entry)
        assert len(set(self._free)) == len(self._free), "free-list duplicates"
        assert set(self._entry.values()) == set(self._refs), "ledger skew"
        assert not (set(self._free) & set(self._refs)), "entry both free+held"
        assert all(r > 0 for r in self._refs.values()), "zero-ref entry held"
