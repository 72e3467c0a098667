# Copy of repro/store/fetcher.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""SegmentFetcher: checksum-verified segment delivery with async prefetch.

The fetcher sits between progressive readers and one or more ByteStores.
Demand ``fetch(key)`` blocks; ``prefetch(keys)`` submits background reads to
a small thread pool so transport overlaps compute (the QoI estimator round
of Algorithm 2 — see core/retrieval.py, which hands ``reassign_eb``'s
predicted next-eps down here via the readers' prefetch hints).

Segments are addressed by ``SegmentEntry`` — ``(blob, offset, size, crc)``.
A single-blob container maps every entry to blob ``""``; a sharded container
(repro_torch.store.container, format v2+) routes each entry to its shard's
ByteStore.  Stores may be handed in directly (one ByteStore, or a mapping
``blob -> ByteStore``) or produced lazily by a resolver callable — a shard
whose variable is never touched is never opened, so dropping a variable's
blob from an object store only breaks sessions that ask for that variable.

Every delivered segment is re-hashed (crc32c) against the manifest before the
decoder sees it; a mismatch raises ChecksumError — a "guaranteed error bound"
computed from silently corrupted planes would be worthless.

Cache discipline: segments are consumed at most once per session (plane
fetches are a monotone prefix per group), so a completed future is *popped*
on fetch — the in-flight map holds only not-yet-consumed prefetches.
Speculative hints the caller never follows up on would otherwise pin their
payloads until close, so ``prefetch`` evicts the oldest completed
*speculative* entries beyond ``max_inflight``.  Non-speculative entries
(exact predictions and fetch_many pipelining) are never evicted — every
internal caller consumes them within a round, and evicting one would force
a duplicate transfer, breaking the equal-bytes-moved property the transfer
benches assert.

An optional cross-session `SegmentCache` sits under all of this: verified
bytes are inserted after their first store read, and later sessions (or a
re-opened reader) are served from RAM — ``stats.store_reads`` counts actual
ByteStore reads, ``stats.cache_hits`` the reads the cache absorbed.  Cache
insertions carry each segment's *plane depth* (``SegmentEntry.depth`` — the
bitplane index, parsed from the manifest key by ``container.segment_depth``)
and this fetcher's ``archive_id`` so the cache can evict depth-weighted
(shared MSB prefixes out-live rarely-shared LSB tails) and enforce
per-archive floors/caps — see repro_torch.store.cache.

``FetchStats`` also aggregates the *contribution-cache* counters
(``contrib_resident_bytes`` / ``contrib_peak_bytes`` / ``contrib_spills`` /
``contrib_recomputes``): every store-backed `_BitplaneVarReader` opened over
this fetcher uses ``stats`` as its ContribStats sink, so one object reports
both transport traffic and reader memory behaviour under a budget (see
core/refactor.py for the exact counter semantics).

Stores whose ``prefers_batch`` attribute is true (HTTPByteStore) receive
multi-segment submissions as one ``read_batch`` call, letting the store
coalesce adjacent ranges into fewer wire round-trips.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, \
    Union

from repro_torch.bitplane.codecs import codec_name
from repro_torch.store.bytestore import ByteStore
from repro_torch.store.cache import SegmentCache
from repro_torch.store.crc import crc32c
from repro_torch.store.retry import (
    OPEN,
    PROBE,
    BlobQuarantine,
    BlobQuarantinedError,
    RetryPolicy,
    is_transient,
)


class ChecksumError(IOError):
    """A fetched segment failed crc32c verification."""


@dataclass(frozen=True, slots=True)
class SegmentEntry:
    """Manifest index entry: where a segment lives and what it must hash to.

    ``depth`` is the segment's progressive depth (bitplane index / snapshot
    index; 0 for signs, masks and other always-needed segments) — cache
    eviction metadata, not addressing.  ``codec`` is the plane-codec id the
    entropy stage chose for this segment (manifest v3; None for non-plane
    segments and for v1/v2 archives, whose payloads are self-describing) —
    transport accounting metadata, not decode state."""
    offset: int
    size: int
    crc: int
    blob: str = ""
    depth: int = 0
    codec: Optional[int] = None


StoreSpec = Union[ByteStore, Mapping[str, ByteStore],
                  Callable[[str], ByteStore]]


@dataclass(slots=True)
class FetchStats:
    """Transport accounting for one fetcher."""
    demand_fetches: int = 0    # blocking reads served straight from store
    pipelined_hits: int = 0    # served by fetch_many's own pipelining
    prefetch_issued: int = 0   # *speculative* background reads submitted
    prefetch_hits: int = 0     # demand fetches answered by a prediction
    bytes_fetched: int = 0     # segment bytes actually pulled from stores
    demand_wait_s: float = 0.0  # time the caller spent blocked on reads
    store_reads: int = 0       # segment reads that hit a ByteStore
    cache_hits: int = 0        # segment reads absorbed by a SegmentCache
    # fault-tolerance counters (see repro_torch.store.retry):
    retries: int = 0           # fetcher-level re-attempts after a failure
    faults_absorbed: int = 0   # failed attempts hidden by a later success
    quarantined_blobs: int = 0  # circuit-open events (blob quarantined)
    # contribution-cache counters (ContribStats sink for store-backed
    # bitplane readers — see core/refactor.py for exact semantics):
    contrib_resident_bytes: int = 0  # contribution fields currently retained
    contrib_peak_bytes: int = 0      # high-water mark of the above
    contrib_spills: int = 0          # fields computed then dropped (budget)
    contrib_recomputes: int = 0      # budget-induced rebuilds of unmoved levels
    # bytes pulled from stores per entropy codec (key = codec name, from the
    # manifest v3 codec field; "untagged" covers masks/snapshots and v1/v2
    # archives) — the on-the-wire view of the encoder's codec choices
    codec_bytes: Dict[str, int] = field(default_factory=dict)
    # guards the contrib_* counters above: this object is the shared
    # ContribStats sink for every store-backed reader of the archive, and
    # under the serve plane those readers mutate from many worker threads —
    # a bare += loses counts (and the peak high-water must see its own
    # delta).  Same contrib_note/contrib_snapshot surface as ContribStats.
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                repr=False, compare=False)

    def contrib_note(self, delta_bytes: int = 0, spills: int = 0,
                     recomputes: int = 0) -> None:
        """Atomically apply a residency delta / spill / recompute event."""
        with self._mu:
            self.contrib_resident_bytes += delta_bytes
            if self.contrib_resident_bytes > self.contrib_peak_bytes:
                self.contrib_peak_bytes = self.contrib_resident_bytes
            self.contrib_spills += spills
            self.contrib_recomputes += recomputes

    def contrib_snapshot(self) -> Tuple[int, int, int, int]:
        with self._mu:
            return (self.contrib_resident_bytes, self.contrib_peak_bytes,
                    self.contrib_spills, self.contrib_recomputes)

    @property
    def hit_rate(self) -> float:
        """Fraction of consumed segments that a *predictive* prefetch had
        already started (fetch_many's pipelining of demanded keys does not
        count — that is latency hiding, not prediction)."""
        served = self.demand_fetches + self.pipelined_hits + self.prefetch_hits
        return self.prefetch_hits / served if served else 0.0


class SegmentFetcher:
    """Keyed, verified access to one archive's segments."""

    def __init__(self, index: Dict[str, SegmentEntry], store: StoreSpec,
                 prefetch_workers: int = 2, verify: bool = True,
                 max_inflight: int = 512,
                 cache: Optional[SegmentCache] = None,
                 archive_id: str = "",
                 retry_policy: Optional[RetryPolicy] = None,
                 quarantine: Optional[BlobQuarantine] = None):
        self.index = index
        self.verify = verify
        self.max_inflight = max_inflight
        self.cache = cache
        self.archive_id = archive_id
        # default = legacy behaviour: one attempt, no circuit breaker.
        # open_archive turns both on for store-backed sessions.
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy.none()
        self.quarantine = quarantine
        self.stats = FetchStats()
        self._lock = threading.Lock()
        # key -> (future, from_hint, evictable): from_hint buckets the stats
        # (prediction vs fetch_many pipelining); evictable marks entries a
        # caller may never consume (speculative predictions)
        self._inflight: Dict[str, Tuple[Future, bool, bool]] = {}
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=prefetch_workers,
                               thread_name_prefix="seg-prefetch")
            if prefetch_workers > 0 else None)
        # blob -> ByteStore, resolved lazily so untouched shards never open;
        # a separate lock because resolution may be slow (e.g. an HTTP HEAD)
        # and must not block fetch()'s bookkeeping
        self._stores_lock = threading.Lock()
        self._stores: Dict[str, ByteStore] = {}
        self._resolver: Optional[Callable[[str], ByteStore]] = None
        if isinstance(store, ByteStore):
            self._stores[""] = store
        elif callable(store):
            self._resolver = store
        else:
            self._stores.update(store)

    # -- stores --------------------------------------------------------------

    def _store_for(self, blob: str) -> ByteStore:
        with self._stores_lock:
            s = self._stores.get(blob)
            if s is None:
                if self._resolver is None:
                    raise KeyError(
                        f"no ByteStore for blob {blob!r} and no resolver")
                s = self._resolver(blob)
                self._stores[blob] = s
            return s

    def _peek_prefers_batch(self, blob: str) -> bool:
        """Batching decision WITHOUT resolving the blob's store on the
        caller's thread — prefetch is fire-and-forget, and resolution may
        be a network round-trip.  Unresolved blobs go down the batch path
        so resolution happens inside the pool worker (``read_batch``
        degrades to a read loop on stores that don't override it)."""
        with self._stores_lock:
            s = self._stores.get(blob)
        if s is None:
            return self._resolver is not None
        return bool(getattr(s, "prefers_batch", False))

    @property
    def store(self) -> ByteStore:
        """The single-blob store (backwards-compatible accessor)."""
        return self._store_for("")

    @property
    def stores(self) -> Dict[str, ByteStore]:
        with self._stores_lock:
            return dict(self._stores)

    # -- transport -----------------------------------------------------------

    def _verify(self, key: str, entry: SegmentEntry, buf: bytes) -> None:
        if len(buf) != entry.size:
            raise IOError(f"segment {key!r}: short read "
                          f"({len(buf)} of {entry.size} bytes)")
        if self.verify and crc32c(buf) != entry.crc:
            raise ChecksumError(
                f"segment {key!r}: crc32c mismatch "
                f"(got {crc32c(buf):#010x}, manifest {entry.crc:#010x})")

    def _cache_key(self, key: str, entry: SegmentEntry):
        return (key, entry.crc)

    def _read_verified(self, key: str) -> bytes:
        entry = self.index[key]
        if self.cache is not None:
            buf = self.cache.get(self._cache_key(key, entry))
            if buf is not None:
                with self._lock:
                    self.stats.cache_hits += 1
                return buf
        buf = self._store_for(entry.blob).read(entry.offset, entry.size)
        self._verify(key, entry, buf)
        cname = codec_name(entry.codec)
        with self._lock:
            self.stats.bytes_fetched += entry.size
            self.stats.store_reads += 1
            self.stats.codec_bytes[cname] = \
                self.stats.codec_bytes.get(cname, 0) + entry.size
        if self.cache is not None and self.verify:
            # a verify=False fetcher must not publish unverified bytes to a
            # shared cache — hits skip re-hashing on the promise that every
            # insert was checked against the manifest
            self.cache.put(self._cache_key(key, entry), buf,
                           depth=entry.depth, archive=self.archive_id)
        return buf

    def _read_retrying(self, key: str, wait_for_probe: bool = True) -> bytes:
        """``_read_verified`` under the fetcher's RetryPolicy and blob
        quarantine.

        Transient failures (timeouts, resets, checksum mismatches — see
        ``retry.is_transient``) retry with capped, jittered backoff inside
        the policy's deadline; permanent ones raise immediately.  Every
        failed attempt feeds the blob's circuit breaker.  On a quarantined
        blob the fetch waits (deadline permitting) for the half-open window
        and makes exactly ONE probe — a failed probe raises immediately
        instead of burning the remaining budget on a blob that is known
        dead; when the wait does not fit the deadline, the fetch fast-fails
        with ``BlobQuarantinedError``.  Retry exhaustion re-raises the last
        *underlying* error, so callers still see ``ChecksumError`` /
        ``FileNotFoundError`` etc. with their original messages.

        ``wait_for_probe=False`` (background pool reads) fast-fails on an
        open circuit instead of sleeping out the cooldown: prefetches queued
        before the circuit opened must not serialize cooldown sleeps on the
        pool — the CONSUMING fetch owns the wait and the single probe (it
        retries on ``BlobQuarantinedError``, see ``fetch``)."""
        policy = self.retry_policy
        q = self.quarantine
        blob = self.index[key].blob
        deadline = policy.deadline_from(time.monotonic())
        last: Optional[BaseException] = None
        failures = 0
        for attempt in range(1, policy.max_attempts + 1):
            if attempt > 1:
                sleep = policy.backoff(attempt - 1)
                if time.monotonic() + sleep > deadline:
                    break                 # out of wall-clock budget
                with self._lock:
                    self.stats.retries += 1
                time.sleep(sleep)
            probing = False
            if q is not None:
                # once a probe token is held the read below MUST run, so its
                # outcome releases the token — no early exits in between
                state, wait = q.check(blob)
                while state == OPEN:
                    if not wait_for_probe \
                            or time.monotonic() + wait > deadline:
                        exc = BlobQuarantinedError(
                            f"segment {key!r}: blob {blob!r} quarantined "
                            f"(next probe in {wait:.3f}s"
                            + ("" if wait_for_probe
                               else "; background read does not wait") + ")")
                        exc.__cause__ = last
                        raise exc
                    time.sleep(wait)
                    state, wait = q.check(blob)
                probing = state == PROBE
            try:
                buf = self._read_verified(key)
            except BaseException as e:
                last = e
                failures += 1
                if q is not None and q.record_failure(blob):
                    with self._lock:
                        self.stats.quarantined_blobs += 1
                if probing or not is_transient(e):
                    raise
                continue
            if q is not None:
                q.record_success(blob)
            if failures:
                with self._lock:
                    self.stats.faults_absorbed += failures
            return buf
        assert last is not None
        raise last                 # budget exhausted: surface the real cause

    def _read_results_many(self, keys: List[str]
                           ) -> Dict[str, object]:
        """Batched read of same-blob keys, letting batch-preferring stores
        (HTTP) coalesce adjacent ranges into fewer round-trips.  Returns
        per-key ``bytes`` or the per-key exception: a transport failure
        fails the whole batch (every miss shares the cause), but a
        verification failure is attributed ONLY to its own segment — the
        other segments in the batch were delivered fine and must not be
        poisoned with a misnamed error."""
        out: Dict[str, object] = {}
        misses: List[str] = []
        for k in keys:
            entry = self.index[k]
            buf = (self.cache.get(self._cache_key(k, entry))
                   if self.cache is not None else None)
            if buf is not None:
                out[k] = buf
                with self._lock:
                    self.stats.cache_hits += 1
            else:
                misses.append(k)
        if not misses:
            return out
        blob = self.index[misses[0]].blob
        try:
            store = self._store_for(blob)
            bufs = store.read_batch([(self.index[k].offset,
                                      self.index[k].size) for k in misses])
        except BaseException as e:          # transport-level: whole batch
            for k in misses:
                out[k] = e
            return out
        ok_bytes = ok_reads = 0
        ok_codec: Dict[str, int] = {}
        for k, buf in zip(misses, bufs):
            entry = self.index[k]
            try:
                self._verify(k, entry, buf)
            except BaseException as e:      # this segment only
                out[k] = e
                continue
            out[k] = buf
            ok_bytes += entry.size
            ok_reads += 1
            cname = codec_name(entry.codec)
            ok_codec[cname] = ok_codec.get(cname, 0) + entry.size
            if self.cache is not None and self.verify:
                self.cache.put(self._cache_key(k, entry), buf,
                               depth=entry.depth, archive=self.archive_id)
        with self._lock:
            self.stats.bytes_fetched += ok_bytes
            self.stats.store_reads += ok_reads
            for cname, nb in ok_codec.items():
                self.stats.codec_bytes[cname] = \
                    self.stats.codec_bytes.get(cname, 0) + nb
        return out

    def _run_single(self, key: str, fut: Future) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(self._read_retrying(key, wait_for_probe=False))
        except BaseException as e:        # surfaced at the consuming fetch
            fut.set_exception(e)

    def _run_batch(self, keys: List[str], futs: Dict[str, Future]) -> None:
        live = [k for k in keys if futs[k].set_running_or_notify_cancel()]
        try:
            res = self._read_results_many(live)
        except BaseException as e:          # defensive: bookkeeping bug
            res = {k: e for k in live}
        for k in live:
            r = res[k]
            if isinstance(r, BaseException) \
                    and self.retry_policy.retries_enabled and is_transient(r):
                # the coalesced first attempt missed this key; spend the
                # rest of the policy's budget on per-key reads (retries
                # don't coalesce — the fault may be range-local)
                try:
                    r = self._read_retrying(k, wait_for_probe=False)
                    with self._lock:
                        self.stats.faults_absorbed += 1   # the batched miss
                except BaseException as e2:
                    r = e2
            if isinstance(r, BaseException):
                futs[k].set_exception(r)
            else:
                futs[k].set_result(r)

    # -- index maintenance (live archives: journal replay) -------------------

    def add_segments(self, entries: Dict[str, SegmentEntry]) -> None:
        """Register newly-journaled segments.  Existing keys must not be
        redefined — the journal is append-only, and silently remapping a key
        a reader already consumed would break byte accounting."""
        with self._lock:
            dup = [k for k in entries if k in self.index]
            if dup:
                raise ValueError(f"journal redefines existing segment "
                                 f"key(s) {sorted(dup)}")
            self.index.update(entries)

    def remove_segments(self, keys: Iterable[str]) -> None:
        """Drop retention-expired segments from the index.  In-flight or
        already-delivered bytes are unaffected; later fetches of a dropped
        key raise KeyError like any unknown key."""
        with self._lock:
            for k in keys:
                self.index.pop(k, None)
                self._inflight.pop(k, None)

    # -- public API ----------------------------------------------------------

    def fetch(self, key: str) -> bytes:
        """Blocking, verified read of one segment (prefetch-aware)."""
        with self._lock:
            entry = self._inflight.pop(key, None)
        t0 = time.perf_counter()
        if entry is not None:
            fut, from_hint, _ = entry
            try:
                buf = fut.result()   # raises ChecksumError from the worker
            except BlobQuarantinedError:
                # the worker fast-failed without spending a retry budget on
                # this key; a demand read gets its own deadline (and the
                # half-open probe, if the cooldown has lapsed by now)
                buf = self._read_retrying(key)
            with self._lock:
                if from_hint:
                    self.stats.prefetch_hits += 1
                else:
                    self.stats.pipelined_hits += 1
        else:
            buf = self._read_retrying(key)
            with self._lock:
                self.stats.demand_fetches += 1
        with self._lock:
            self.stats.demand_wait_s += time.perf_counter() - t0
        return buf

    def fetch_many(self, keys: Iterable[str]) -> List[bytes]:
        """Fetch a known list of segments.  With a worker pool the tail keys
        are submitted up front, so per-request latency pipelines instead of
        accumulating serially — these are demanded (not speculative) keys,
        so nothing extra ever moves."""
        keys = list(keys)
        if self._pool is not None and len(keys) > 1:
            self._submit(keys, from_hint=False, evictable=False)
        return [self.fetch(k) for k in keys]

    def fetch_prefix(self, keys: Iterable[str]
                     ) -> Tuple[List[bytes], Optional[BaseException]]:
        """Fetch an ordered list of segments, stopping at the first one that
        cannot be delivered: returns ``(buffers, error)`` where ``buffers``
        is the longest deliverable prefix and ``error`` is ``None`` only
        when every key arrived.  This is degraded mode's workhorse — a
        bitplane prefix is useful exactly as far as it is contiguous, so a
        miss at plane k makes planes >k moot for this session."""
        keys = list(keys)
        if self._pool is not None and len(keys) > 1:
            self._submit(keys, from_hint=False, evictable=False)
        bufs: List[bytes] = []
        for i, k in enumerate(keys):
            try:
                bufs.append(self.fetch(k))
            except Exception as e:
                # the tail is moot: forget its in-flight entries so futures
                # nobody will consume don't pin payloads until close()
                with self._lock:
                    for tail in keys[i + 1:]:
                        self._inflight.pop(tail, None)
                return bufs, e
        return bufs, None

    def prefetch(self, keys: Iterable[str], certain: bool = True) -> None:
        """Start background fetches for hinted keys; no-op without a worker
        pool.  Keys already in flight (or unknown) are skipped.
        ``certain=False`` marks predictions the caller may abandon — those
        entries are eviction-eligible once completed."""
        self._submit(keys, from_hint=True, evictable=not certain)

    def _submit(self, keys: Iterable[str], from_hint: bool,
                evictable: bool) -> None:
        if self._pool is None:
            return
        with self._lock:
            keys = list(keys)
            if not evictable:
                # a certain hint supersedes an earlier speculative one for
                # the same key: the segment WILL be consumed now, so it must
                # no longer be eviction-eligible
                for k in keys:
                    entry = self._inflight.get(k)
                    if entry is not None and entry[2]:
                        self._inflight[k] = (entry[0], entry[1], False)
            fresh = [k for k in keys
                     if k in self.index and k not in self._inflight]
            if from_hint and self.quarantine is not None:
                # speculative reads on a quarantined blob would fill the
                # pool with cooldown sleeps; let demand fetches (which own
                # a deadline) decide whether to wait for the probe
                fresh = [k for k in fresh if not self.quarantine
                         .is_quarantined(self.index[k].blob)]
            # evict oldest completed *evictable* entries (abandoned
            # predictions) so unconsumed speculation cannot pin the archive;
            # certain entries are always consumed by their caller, and
            # evicting one would force a duplicate transfer
            over = len(self._inflight) + len(fresh) - self.max_inflight
            if over > 0:
                for k in [k for k, (f, _, ev) in self._inflight.items()
                          if ev and f.done()][:over]:
                    del self._inflight[k]
            # register manually-fulfilled futures under the lock (so a
            # concurrent _submit cannot double-read a key), then hand the
            # reads to the pool outside it — store resolution may be slow
            futs: Dict[str, Future] = {}
            for k in fresh:
                f: Future = Future()
                self._inflight[k] = (f, from_hint, evictable)
                self.stats.prefetch_issued += from_hint
                futs[k] = f
        if not futs:
            return
        by_blob: Dict[str, List[str]] = {}
        for k in futs:
            by_blob.setdefault(self.index[k].blob, []).append(k)
        submitted = set()
        pool = self._pool
        try:
            if pool is None:
                raise RuntimeError("fetcher closed during submission")
            for blob, ks in by_blob.items():
                if len(ks) > 1 and self._peek_prefers_batch(blob):
                    ks.sort(key=lambda k: self.index[k].offset)
                    pool.submit(self._run_batch, ks, futs)
                    submitted.update(ks)
                else:
                    for k in ks:
                        pool.submit(self._run_single, k, futs[k])
                        submitted.add(k)
        except RuntimeError as e:
            # pool shut down while we were submitting (close() raced a
            # prefetch): fail the unsubmitted futures instead of leaving
            # them pending forever — a later fetch() must not hang
            for k, f in futs.items():
                if k not in submitted and f.set_running_or_notify_cancel():
                    f.set_exception(e)

    def drain(self) -> None:
        """Wait for all in-flight prefetches (tests/benchmarks)."""
        with self._lock:
            futs = [f for f, _, _ in self._inflight.values()]
        for f in futs:
            try:
                f.result()
            except Exception:       # surfaced on the consuming fetch instead
                pass

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._inflight)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def close_stores(self) -> None:
        """Close every ByteStore this fetcher resolved or was handed."""
        with self._stores_lock:
            stores, self._stores = dict(self._stores), {}
        for s in stores.values():
            s.close()

    def __enter__(self) -> "SegmentFetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
