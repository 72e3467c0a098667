# Copy of repro/store/cache.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""Cross-session segment cache with depth-weighted, archive-aware eviction.

Within one `RetrievalSession`, segments are consumed at most once (plane
fetches are a monotone prefix per group), so the SegmentFetcher *pops*
completed reads — correct for a single client, but a server running many
sessions over the same archive re-fetches identical planes for every
client.  `SegmentCache` sits under the fetcher: verified segment bytes are
inserted after their first store read and served to every later session
without touching the ByteStore (see ``FetchStats.store_reads`` vs
``cache_hits``).

Keys are ``(segment_key, crc32c)`` pairs: the crc disambiguates segments of
different archives sharing one cache, and means a hit never needs
re-verification — the bytes were hashed against the manifest when inserted.

Eviction policy
---------------
Progressive workloads are *prefix-heavy*: every client consumes the MSB
planes of the variables it touches, while deep LSB planes serve only the
tightest-tolerance clients.  Pure byte-LRU treats both the same, so one
deep-descending client can flush the shared prefix that every other client
re-reads.  Eviction is therefore **depth-weighted LRU**: each entry carries
a ``depth`` (its bitplane index for plane segments, snapshot index for
snapshot blobs, 0 for signs/masks — see ``repro_torch.store.container
.segment_depth``) and the victim is the entry minimising

    score = last_use_tick − depth_weight · min(depth, _MAX_BAND)

where ``tick`` is a global access counter.  At equal recency a deeper
(LSB) segment always goes first; an MSB segment must be ``depth_weight``
ticks *staler* per plane of depth before it loses to an LSB one.
``depth_weight=0`` recovers plain byte-LRU.

Archive isolation
-----------------
Entries are also tagged with an ``archive`` id (the fetcher passes a hash
of its manifest).  Two knobs keep one hot archive from flushing another's
working set:

  * ``archive_floor_bytes`` — eviction for *global* pressure never takes an
    archive below this many resident bytes unless the pressure comes from
    that archive's own insertions (self-pressure may always self-evict).
  * ``archive_max_bytes`` — optional hard per-archive cap; inserting beyond
    it evicts only within the inserting archive.

Floors are a protection, not a reservation: if every other archive is at
its floor the inserting archive evicts itself, and the global
``max_bytes`` bound always holds.

Depth and archive default to ``0`` / ``""`` on ``put``, so callers that
never learned the new metadata keep plain-LRU semantics unchanged.

Admission control (serve plane)
-------------------------------
With ``admission_control=True`` a ``put`` that would overflow the cache
first compares the incoming entry's score against the stalest resident
entry: when the newcomer scores LOWER (a deep-LSB segment from one
tight-tolerance client, up against a shared MSB prefix), inserting it
would evict hotter bytes only to be evicted moments later itself — so the
insert is *skipped* (``stats.admission_skips``) and the resident set is
left alone.  Correctness is unaffected (the fetcher falls through to the
ByteStore); this is purely churn avoidance under multi-tenant pressure.
Default off: single-session workloads want every verified byte cached.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

# Depth bands beyond this saturate: a plane 40 deep and one 60 deep are
# both "cold tail" — capping keeps the head-scan per eviction tiny.
_MAX_BAND = 48


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    floor_protected: int = 0   # evictions redirected off an at-floor archive
    admission_skips: int = 0   # inserts refused under pressure (colder than
    #                            every resident entry; admission_control only)


@dataclass(slots=True)
class _Entry:
    data: bytes
    depth: int
    band: int
    archive: str
    tick: int


@dataclass(slots=True)
class _ArchiveState:
    """Per-archive residency: byte count + one LRU queue per depth band.

    Within a band, queue order is insertion/touch order, so the queue head
    is the band's minimum-tick (stalest) entry — scanning only the heads of
    every (archive, band) queue finds the global minimum score."""
    nbytes: int = 0
    bands: Dict[int, "OrderedDict[Hashable, _Entry]"] = field(
        default_factory=dict)


class SegmentCache:
    """Thread-safe byte-bounded cache, depth-weighted LRU within and across
    per-archive budgets (see module docstring)."""

    def __init__(self, max_bytes: int = 256 << 20,
                 depth_weight: float = 64.0,
                 archive_floor_bytes: int = 0,
                 archive_max_bytes: Optional[int] = None,
                 admission_control: bool = False):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        if depth_weight < 0:
            raise ValueError("depth_weight must be >= 0")
        if archive_max_bytes is not None and archive_max_bytes <= 0:
            raise ValueError("archive_max_bytes must be positive or None")
        self.max_bytes = int(max_bytes)
        self.depth_weight = float(depth_weight)
        self.archive_floor_bytes = int(archive_floor_bytes)
        self.archive_max_bytes = archive_max_bytes
        self.admission_control = bool(admission_control)
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, _Entry] = {}
        self._archives: Dict[str, _ArchiveState] = {}
        self._nbytes = 0
        self._tick = 0

    # -- internals (call with the lock held) ---------------------------------

    def _queue(self, archive: str, band: int
               ) -> "OrderedDict[Hashable, _Entry]":
        st = self._archives.setdefault(archive, _ArchiveState())
        q = st.bands.get(band)
        if q is None:
            q = st.bands[band] = OrderedDict()
        return q

    def _remove(self, key: Hashable, entry: _Entry) -> None:
        st = self._archives[entry.archive]
        del st.bands[entry.band][key]
        if not st.bands[entry.band]:
            del st.bands[entry.band]
        st.nbytes -= len(entry.data)
        if st.nbytes == 0 and not st.bands:
            del self._archives[entry.archive]
        del self._entries[key]
        self._nbytes -= len(entry.data)

    def _score(self, entry: _Entry) -> float:
        return entry.tick - self.depth_weight * entry.band

    def _victim(self, for_archive: str) -> Optional[Tuple[Hashable, _Entry]]:
        """Minimum-score entry among eviction candidates: the inserting
        archive's own entries, plus entries of archives above their floor.
        Falls back to the unrestricted minimum when floors protect
        everything else (the global byte bound must hold regardless)."""
        best: Optional[Tuple[Hashable, _Entry]] = None
        fallback: Optional[Tuple[Hashable, _Entry]] = None
        protected = False
        for name, st in self._archives.items():
            for q in st.bands.values():
                key, entry = next(iter(q.items()))     # band head = stalest
                # exact floor guarantee: external pressure may take this
                # entry only if the archive stays at/above its floor after
                eligible = (name == for_archive
                            or st.nbytes - len(entry.data)
                            >= self.archive_floor_bytes)
                cand = (key, entry)
                if fallback is None or \
                        self._score(entry) < self._score(fallback[1]):
                    fallback = cand
                if not eligible:
                    protected = True
                    continue
                if best is None or \
                        self._score(entry) < self._score(best[1]):
                    best = cand
        if best is None:
            return fallback
        if protected and fallback is not None and fallback[1] is not best[1]:
            self.stats.floor_protected += 1
        return best

    def _evict_one(self, for_archive: str) -> None:
        victim = self._victim(for_archive)
        if victim is None:                  # cache empty — nothing to do
            return
        self._remove(*victim)
        self.stats.evictions += 1

    def _min_resident_score(self) -> Optional[float]:
        """Lowest score among resident entries — scanning only band heads
        (each queue head is its band's minimum tick).  Pure read: unlike
        ``_victim`` it never touches the floor_protected stat, so the
        admission check cannot masquerade as floor pressure."""
        best: Optional[float] = None
        for st in self._archives.values():
            for q in st.bands.values():
                entry = next(iter(q.values()))
                score = self._score(entry)
                if best is None or score < best:
                    best = score
        return best

    def _evict_within(self, archive: str) -> None:
        """Per-archive cap: evict the minimum-score entry of one archive."""
        st = self._archives.get(archive)
        if st is None:
            return
        best: Optional[Tuple[Hashable, _Entry]] = None
        for q in st.bands.values():
            key, entry = next(iter(q.items()))
            if best is None or self._score(entry) < self._score(best[1]):
                best = (key, entry)
        if best is not None:
            self._remove(*best)
            self.stats.evictions += 1

    # -- public API ----------------------------------------------------------

    def get(self, key: Hashable) -> Optional[bytes]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._tick += 1
            entry.tick = self._tick
            self._archives[entry.archive].bands[entry.band] \
                .move_to_end(key)
            self.stats.hits += 1
            return entry.data

    def put(self, key: Hashable, data: bytes, depth: int = 0,
            archive: str = "") -> None:
        if len(data) > self.max_bytes:
            return                      # would evict everything for one entry
        with self._lock:
            old = self._entries.get(key)
            if old is None and self.admission_control and \
                    self._nbytes + len(data) > self.max_bytes:
                band = min(max(int(depth), 0), _MAX_BAND)
                floor = self._min_resident_score()
                # the newcomer would enter at tick+1; if even then it scores
                # below the stalest resident entry, inserting means evicting
                # hotter bytes to hold a segment that loses the very next
                # comparison — skip it and keep the resident set intact
                # (a re-put of a resident key is a refresh, never admission)
                if floor is not None and \
                        (self._tick + 1) - self.depth_weight * band < floor:
                    self.stats.admission_skips += 1
                    return
            if old is not None:
                self._remove(key, old)
            self._tick += 1
            entry = _Entry(data=data, depth=int(depth),
                           band=min(max(int(depth), 0), _MAX_BAND),
                           archive=archive, tick=self._tick)
            self._queue(archive, entry.band)[key] = entry
            self._entries[key] = entry
            st = self._archives[archive]
            st.nbytes += len(data)
            self._nbytes += len(data)
            self.stats.insertions += 1
            while self._nbytes > self.max_bytes and self._entries:
                self._evict_one(for_archive=archive)
            if self.archive_max_bytes is not None:
                while self._archives.get(archive) is not None and \
                        self._archives[archive].nbytes > self.archive_max_bytes:
                    self._evict_within(archive)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._archives.clear()
            self._nbytes = 0

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def archive_nbytes(self, archive: str = "") -> int:
        """Resident bytes attributed to one archive id."""
        with self._lock:
            st = self._archives.get(archive)
            return st.nbytes if st is not None else 0

    def archives(self) -> List[str]:
        with self._lock:
            return list(self._archives)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries
