"""Slot residency bookkeeping for host↔device paging — the LRU + pin
protocol shared by ``repro_torch.serving.AdapterStore`` (read-only
adapter bank) and ``repro_torch.federated.client_store.ClientStateStore``
(read-write client bank with write-back).

The pager tracks WHICH id occupies WHICH slot of a fixed-size device bank;
it never touches device memory itself.  Callers own the actual page-in
scatter / write-back gather and consult the pager for placement:

* :meth:`lookup` — resident slot of an id (or ``None``);
* :meth:`assign` — place a cold id: a free slot if one exists, else the
  least-recently-used *unpinned* resident is evicted (its id is returned so
  the caller can write dirty rows back before overwriting the slot);
* :meth:`pin` / :meth:`unpin` — pinned ids are never evicted (in-flight
  serving requests; federated cohorts between dispatch and retirement);
* :meth:`touch` — refresh an id's LRU recency;
* :meth:`hit` — touch + count one residency hit (callers' resident path);
* :meth:`drop` — forget an id (explicit overwrite / invalidation).

Hit/miss/eviction accounting: ``hits`` counts :meth:`hit` calls, ``misses``
counts successful :meth:`assign` placements (a rejected assign — all slots
pinned — counts NOTHING: no eviction happened, and the caller retries the
same id later), ``evictions`` counts LRU displacements.  Both stores
(``AdapterStore``, ``ClientStateStore``) surface these identically through
their ``paging_stats`` property; the telemetry registry exports them as
pager hit-rate gauges.

Everything is O(residents) at worst and host-only, so the protocol adds no
device syncs to any hot path.
"""

from __future__ import annotations

import collections
from typing import Hashable


class AllSlotsPinnedError(RuntimeError):
    """Raised by :meth:`LRUPager.assign` when every slot is pinned: no id
    can be placed until one is released."""


class LRUPager:
    """LRU slot allocator with pinning over a bank of ``slots`` rows.

    ``kind`` names the paged object in error messages ("adapter" for the
    serving bank, "client" for the federated store).  ``pins`` is a public
    ``Counter`` — entries may be inspected (and are shared with legacy
    aliases like ``AdapterStore._pins``).
    """

    def __init__(self, slots: int, *, kind: str = "adapter"):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = slots
        self.kind = kind
        self.slot_of: dict[Hashable, int] = {}      # resident id -> slot
        self.id_at: list[Hashable | None] = [None] * slots
        self.pins: collections.Counter = collections.Counter()
        self.lru: dict[Hashable, int] = {}          # resident id -> last tick
        self.tick = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- queries
    @property
    def resident_ids(self) -> list[Hashable]:
        return [i for i in self.id_at if i is not None]

    def lookup(self, ident: Hashable) -> int | None:
        return self.slot_of.get(ident)

    def pinned(self, ident: Hashable) -> bool:
        return self.pins.get(ident, 0) > 0

    def stats(self) -> dict:
        """Hit/miss/eviction accounting (shared ``paging_stats`` schema)."""
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}

    # ----------------------------------------------------------- mutation
    def touch(self, ident: Hashable) -> None:
        self.tick += 1
        self.lru[ident] = self.tick

    def hit(self, ident: Hashable) -> None:
        """Touch a resident id and count the residency hit."""
        self.hits += 1
        self.touch(ident)

    def pin(self, ident: Hashable) -> None:
        if ident not in self.slot_of:
            raise KeyError(f"{self.kind} {ident!r} is not resident")
        self.pins[ident] += 1

    def unpin(self, ident: Hashable) -> None:
        if self.pins.get(ident, 0) <= 0:
            raise RuntimeError(f"{self.kind} {ident!r} is not pinned")
        self.pins[ident] -= 1

    def drop(self, ident: Hashable) -> None:
        """Forget a resident id (no eviction accounting — explicit
        invalidation by the caller, e.g. re-register of a hot adapter)."""
        slot = self.slot_of.pop(ident)
        self.id_at[slot] = None
        self.lru.pop(ident, None)
        self.pins.pop(ident, None)

    def assign(self, ident: Hashable) -> tuple[int, Hashable | None]:
        """Place a non-resident id; returns ``(slot, evicted_id)`` where
        ``evicted_id`` is the LRU unpinned resident that made room (``None``
        when a slot was free).  The caller must write back any dirty state
        of ``evicted_id`` BEFORE overwriting the slot's device row."""
        if ident in self.slot_of:
            raise RuntimeError(f"{self.kind} {ident!r} is already resident")
        evicted = None
        slot = next((s for s, occ in enumerate(self.id_at) if occ is None),
                    None)
        if slot is None:
            victims = [i for i in self.slot_of if self.pins[i] == 0]
            if not victims:
                raise AllSlotsPinnedError(
                    f"all {self.slots} {self.kind} slots are pinned by "
                    "in-flight requests; release one or grow the store")
            evicted = min(victims, key=lambda i: self.lru[i])
            slot = self.slot_of[evicted]
            self.drop(evicted)
            self.evictions += 1
        # counted only on successful placement: a pinned-full rejection
        # (raise above) leaves hit/miss/eviction accounting untouched
        self.misses += 1
        self.slot_of[ident] = slot
        self.id_at[slot] = ident
        self.touch(ident)
        return slot, evicted
