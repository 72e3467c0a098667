"""Server-level pooled contribution budget (borrow/return leases).

Counterpart of ``repro/serve/budget.py`` (pure stdlib, copied as it is).

The per-variable ``contrib_budget_bytes`` cap splits the server's
memory statically: a cold variable hoards its share while a hot one
recomputes contributions every refresh.  ``ContribBudgetPool`` replaces
that with ONE server-wide pool that every bitplane reader borrows
field-sized leases from, so residency follows demand — the hottest
variables win.

Protocol (see ``_BitplaneVarReader._refresh_hb_incremental`` in
core/refactor.py):

  * ``retain(owner, slot, level, nbytes, value)`` — atomically grant or
    refresh a lease and *deposit* the contribution field into the owner's
    slot.  If the pool is full, holdings with a strictly worse
    depth-weighted recency score are reclaimed first (their owners' slots
    are cleared under the pool lock via ``owner._pool_set_contrib``); if
    not enough reclaimable bytes exist, the request is denied and the
    caller spills (recompute-on-demand keeps outputs bit-identical).
  * ``release_owner(owner)`` — return every lease of a closing reader.

Victim scoring mirrors the SegmentCache: ``score = tick − depth_weight ·
level``.  Fine levels (low ``level``) are the hottest (size-weighted eps
splits give them the most planes in flight, and their rebuild is the
cheapest to skip), so a *positive* depth weight ages coarse holdings
faster.  All slot mutations for pooled readers happen under the pool
lock, which is what makes cross-session reclaim safe: a reader never
observes a half-cleared slot, and the accounting in ``ContribStats``
moves in the same critical section.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass
class PoolStats:
    """Counters for one ContribBudgetPool (all mutated under its lock)."""
    borrowed_bytes: int = 0
    peak_borrowed_bytes: int = 0
    leases: int = 0
    grants: int = 0
    touches: int = 0
    denials: int = 0
    reclaims: int = 0

    def snapshot(self) -> Dict[str, float]:
        return {
            "borrowed_bytes": float(self.borrowed_bytes),
            "peak_borrowed_bytes": float(self.peak_borrowed_bytes),
            "leases": float(self.leases),
            "grants_total": float(self.grants),
            "touches_total": float(self.touches),
            "denials_total": float(self.denials),
            "reclaims_total": float(self.reclaims),
        }


@dataclass
class _Lease:
    owner: object
    slot: int
    level: int
    nbytes: int
    tick: int


class ContribBudgetPool:
    """One server-wide contribution-memory pool shared by all sessions.

    ``total_bytes`` caps the sum of outstanding leases; ``depth_weight``
    tunes how aggressively coarse-level holdings are reclaimed in favour
    of fine-level ones (0 = pure LRU across the server).
    """

    def __init__(self, total_bytes: int, depth_weight: float = 4.0):
        if total_bytes < 0:
            raise ValueError("total_bytes must be >= 0")
        self.total_bytes = int(total_bytes)
        self.depth_weight = float(depth_weight)
        self._mu = threading.Lock()
        self._leases: Dict[Tuple[int, int], _Lease] = {}
        self._tick = 0
        self.stats = PoolStats()

    # -- scoring ----------------------------------------------------------
    def _score(self, tick: int, level: int) -> float:
        return tick - self.depth_weight * level

    # -- lease surface ----------------------------------------------------
    def retain(self, owner, slot: int, level: int, nbytes: int,
               value) -> bool:
        """Grant/refresh a lease for ``owner``'s contribution ``slot`` and
        deposit ``value`` there; returns False (and leaves the slot empty)
        when the pool cannot make room without reclaiming hotter holdings.
        """
        nbytes = int(nbytes)
        key = (id(owner), slot)
        with self._mu:
            self._tick += 1
            lease = self._leases.get(key)
            if lease is not None:
                lease.tick = self._tick
                self.stats.touches += 1
                owner._pool_set_contrib(slot, value)
                return True
            if nbytes > self.total_bytes:
                self.stats.denials += 1
                return False
            if not self._make_room(nbytes, self._score(self._tick, level)):
                self.stats.denials += 1
                return False
            self._leases[key] = _Lease(owner=owner, slot=slot, level=level,
                                       nbytes=nbytes, tick=self._tick)
            self.stats.borrowed_bytes += nbytes
            if self.stats.borrowed_bytes > self.stats.peak_borrowed_bytes:
                self.stats.peak_borrowed_bytes = self.stats.borrowed_bytes
            self.stats.leases = len(self._leases)
            self.stats.grants += 1
            owner._pool_set_contrib(slot, value)
            return True

    def _make_room(self, nbytes: int, requester_score: float) -> bool:
        """Reclaim strictly-worse-scored leases until ``nbytes`` fit.

        Returns False (reclaiming nothing) when even evicting every
        worse-scored holding would not free enough — an all-or-nothing
        plan keeps a denied request from churning other readers' caches.
        """
        need = self.stats.borrowed_bytes + nbytes - self.total_bytes
        if need <= 0:
            return True
        victims = sorted(
            (l for l in self._leases.values()
             if self._score(l.tick, l.level) < requester_score),
            key=lambda l: self._score(l.tick, l.level))
        freed, plan = 0, []
        for lease in victims:
            plan.append(lease)
            freed += lease.nbytes
            if freed >= need:
                break
        if freed < need:
            return False
        for lease in plan:
            self._drop(lease)
            self.stats.reclaims += 1
        return True

    def _drop(self, lease: _Lease) -> None:
        del self._leases[(id(lease.owner), lease.slot)]
        self.stats.borrowed_bytes -= lease.nbytes
        self.stats.leases = len(self._leases)
        lease.owner._pool_set_contrib(lease.slot, None)

    def release(self, owner, slot: int) -> None:
        """Return one lease (no-op when not held)."""
        with self._mu:
            lease = self._leases.get((id(owner), slot))
            if lease is not None:
                self._drop(lease)

    def release_owner(self, owner) -> None:
        """Return every lease held by ``owner`` (reader/session close)."""
        with self._mu:
            for lease in [l for l in self._leases.values()
                          if l.owner is owner]:
                self._drop(lease)

    def holds(self, owner, slot: int) -> bool:
        with self._mu:
            return (id(owner), slot) in self._leases

    @property
    def borrowed_bytes(self) -> int:
        with self._mu:
            return self.stats.borrowed_bytes

    def metrics(self) -> Dict[str, float]:
        with self._mu:
            out = self.stats.snapshot()
        out["total_bytes"] = float(self.total_bytes)
        return out
