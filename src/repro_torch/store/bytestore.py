# Copy of repro/store/bytestore.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""Pluggable byte stores: where an archive container's bytes physically live.

One interface — ``read(offset, length)`` over a flat address space — with
four backends:

  * MemoryByteStore   bytes in RAM (tests, and the write target of
                      ``save_archive`` before flushing to disk);
  * FileByteStore     a local file, mmap'd so range reads are zero-copy page
                      faults instead of seek+read syscalls;
  * HTTPByteStore     a real network backend: HTTP ranged GETs
                      (``Range: bytes=a-b``) over persistent per-thread
                      connections, with retry/exponential-backoff on
                      5xx/timeouts and adjacent-range coalescing in
                      ``read_batch``;
  * RemoteByteStore   wraps another store behind a modelled network link
                      (per-request latency + bandwidth, single shared link),
                      so benchmarks measure real end-to-end *time*, not just
                      byte counts — and so prefetch has actual latency to
                      hide.  The model is validated against HTTPByteStore
                      over loopback in benchmarks/bench_store.py.

All backends are thread-safe: the SegmentFetcher issues background reads
from its prefetch executor while the caller decodes on the main thread.
"""
from __future__ import annotations

import http.client
import mmap
import os
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.store.retry import RetryPolicy


def _check_range(offset: int, length: int, size: int, label: str) -> None:
    """Uniform range validation for every backend: a negative length is a
    caller bug (not an EOF condition) and must never silently truncate."""
    if length < 0:
        raise ValueError(f"negative read length {length} on {label}")
    if offset < 0 or offset + length > size:
        raise EOFError(f"read [{offset}, {offset + length}) outside "
                       f"{label} of {size} bytes")


class ByteStore:
    """Range-readable byte container."""

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def read_batch(self, ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        """Read several ``(offset, length)`` ranges; results in call order.
        Backends with per-request overhead override this to coalesce
        adjacent ranges into fewer wire requests."""
        return [self.read(off, ln) for off, ln in ranges]

    @property
    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "ByteStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MemoryByteStore(ByteStore):
    def __init__(self, data: bytes):
        self._data = data

    def read(self, offset: int, length: int) -> bytes:
        _check_range(offset, length, len(self._data), "memory store")
        return bytes(self._data[offset:offset + length])

    @property
    def size(self) -> int:
        return len(self._data)


class FileByteStore(ByteStore):
    """mmap-backed local file store (read-only)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._size = os.fstat(self._fh.fileno()).st_size
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ) \
            if self._size else None

    def read(self, offset: int, length: int) -> bytes:
        _check_range(offset, length, self._size, self.path)
        return self._mm[offset:offset + length] if length else b""

    @property
    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._fh.close()


@dataclass
class HTTPStats:
    """Accounting for a real HTTP link."""
    requests: int = 0          # HTTP requests that returned a usable response
    retries: int = 0           # attempts repeated after a 5xx/transport error
    bytes_moved: int = 0       # payload bytes received (incl. coalescing gaps)
    coalesced_ranges: int = 0  # ranges merged into a neighbour's request
    wasted_bytes: int = 0      # gap bytes transferred only to merge ranges
    not_modified: int = 0      # conditional GETs answered 304 from our cache


class HTTPByteStore(ByteStore):
    """Ranged-GET byte store over HTTP(S) — the archive's real wire path.

    * connection reuse: one persistent ``http.client`` connection per thread
      (the SegmentFetcher reads from its prefetch pool and the main thread
      concurrently), re-established transparently after errors;
    * ``read_batch`` coalesces ranges whose gap is <= ``coalesce_gap`` bytes
      into a single ranged GET — per-request latency dominates small segment
      reads, so paying a few wasted gap bytes for one round-trip is the same
      trade HTTP/2 clients make — and ``prefers_batch`` advertises this to
      the fetcher;
    * transient failures (HTTP 5xx, timeouts, connection resets) retry with
      exponential backoff; 4xx are caller errors and raise immediately.
    """

    prefers_batch = True

    def __init__(self, url: str, timeout_s: float = 10.0,
                 max_retries: int = 4, backoff_s: float = 0.05,
                 coalesce_gap: int = 4096, size: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"HTTPByteStore needs an http(s) URL, got {url!r}")
        self.url = url
        self._host = parts.netloc
        self._path = parts.path or "/"
        if parts.query:
            self._path += "?" + parts.query
        self._conn_cls = (http.client.HTTPSConnection
                          if parts.scheme == "https"
                          else http.client.HTTPConnection)
        self.timeout_s = float(timeout_s)
        # the unified policy subsumes the legacy (max_retries, backoff_s)
        # knobs, which stay as a convenience spelling of the same thing
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(max_attempts=int(max_retries) + 1,
                             backoff_s=float(backoff_s))
        self.max_retries = self.retry_policy.max_attempts - 1
        self.backoff_s = self.retry_policy.backoff_s
        self.coalesce_gap = int(coalesce_gap)
        self.stats = HTTPStats()
        self._stats_lock = threading.Lock()
        self._local = threading.local()
        # every thread's persistent connection, so close() can close them
        # all — threading.local alone would leak the pool threads' sockets
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        self._closed = False
        # probed lazily on first use: opening a store must not cost a HEAD
        # round-trip when the caller already knows the size (sharded
        # manifests record every blob's size) or only wants read_all()
        self._size: Optional[int] = None if size is None else int(size)
        # conditional-GET state for read_all: the last full body plus the
        # validator it arrived under (None until a server sends an ETag)
        self._etag: Optional[str] = None
        self._body_cache: Optional[bytes] = None

    # -- connection management ----------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._conn_cls(self._host, timeout=self.timeout_s)
            conn.connect()
            # mirror the server's disable_nagle_algorithm: request headers
            # go out in small writes, and Nagle would hold them hostage to
            # the server's delayed ACK (~40ms per exchange)
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.add(conn)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()
            self._local.conn = None

    def _request(self, method: str, headers: dict) -> Tuple[int, dict, bytes]:
        """One HTTP exchange with retry/backoff; returns (status, headers,
        body).  Retries 5xx and transport-level failures; anything else is
        returned to the caller for interpretation."""
        if self._closed:
            raise ValueError(f"I/O on closed HTTPByteStore {self.url}")
        last_err: Optional[Exception] = None
        policy = self.retry_policy
        deadline = policy.deadline_from(time.monotonic())
        attempts = 0
        for attempt in range(policy.max_attempts):
            if attempt:
                sleep = policy.backoff(attempt)
                if time.monotonic() + sleep > deadline:
                    break                 # out of wall-clock budget
                with self._stats_lock:
                    self.stats.retries += 1
                time.sleep(sleep)
            attempts += 1
            try:
                conn = self._conn()
                conn.request(method, self._path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                if resp.will_close:
                    self._drop_conn()
                if resp.status >= 500:
                    last_err = IOError(f"HTTP {resp.status} {resp.reason}")
                    continue
                with self._stats_lock:
                    self.stats.requests += 1
                return resp.status, dict(resp.getheaders()), body
            except (socket.timeout, ConnectionError, OSError,
                    http.client.HTTPException) as e:
                last_err = e
                self._drop_conn()
        raise IOError(f"{method} {self.url}: giving up after "
                      f"{attempts} attempts: {last_err}")

    def _probe_size(self) -> int:
        status, headers, _ = self._request("HEAD", {})
        if status != 200:
            raise IOError(f"HEAD {self.url}: HTTP {status}")
        clen = {k.lower(): v for k, v in headers.items()}.get("content-length")
        if clen is None:
            raise IOError(f"HEAD {self.url}: no Content-Length")
        return int(clen)

    # -- reads ---------------------------------------------------------------

    def _ranged_get(self, offset: int, length: int) -> bytes:
        status, _, body = self._request(
            "GET", {"Range": f"bytes={offset}-{offset + length - 1}"})
        if status == 206:
            data = body
        elif status == 200:
            # server ignored Range and sent the whole resource
            data = body[offset:offset + length]
        else:
            raise IOError(f"GET {self.url} [{offset}:+{length}]: "
                          f"HTTP {status}")
        if len(data) != length:
            raise IOError(f"GET {self.url} [{offset}:+{length}]: got "
                          f"{len(data)} bytes")
        with self._stats_lock:
            self.stats.bytes_moved += len(body)
        return data

    def read_all(self) -> bytes:
        """One plain GET of the whole resource (no size probe, no Range) —
        the cheap path for small metadata like a sharded manifest.

        Conditional on re-read: when the first GET carried an ``ETag``, the
        body is kept and every later ``read_all`` revalidates with
        ``If-None-Match`` — a ``304`` serves the cached body for the cost
        of a header exchange.  This is the polling primitive a live
        append-only archive needs: manifest unchanged -> no transfer,
        manifest rewritten -> new ETag -> fresh body, never a stale mix."""
        headers = {}
        with self._stats_lock:
            etag, cached = self._etag, self._body_cache
        if etag is not None and cached is not None:
            headers["If-None-Match"] = etag
        status, resp_headers, body = self._request("GET", headers)
        if status == 304:
            with self._stats_lock:
                self.stats.not_modified += 1
            return cached
        if status != 200:
            raise IOError(f"GET {self.url}: HTTP {status}")
        new_etag = {k.lower(): v for k, v in resp_headers.items()}.get("etag")
        with self._stats_lock:
            self.stats.bytes_moved += len(body)
            self._etag = new_etag
            self._body_cache = body if new_etag is not None else None
        if self._size is None:
            self._size = len(body)
        return body

    def read(self, offset: int, length: int) -> bytes:
        _check_range(offset, length, self.size, self.url)
        if length == 0:
            return b""
        return self._ranged_get(offset, length)

    def read_batch(self, ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        ranges = list(ranges)
        size = self.size
        for off, ln in ranges:
            _check_range(off, ln, size, self.url)
        # coalesce in offset order, then slice results back into call order
        order = sorted((r for r in ranges if r[1] > 0),
                       key=lambda r: r[0])
        spans: List[Tuple[int, int]] = []          # (start, end) merged GETs
        for off, ln in order:
            if spans and off <= spans[-1][1] + self.coalesce_gap:
                if off + ln > spans[-1][1]:
                    spans[-1] = (spans[-1][0], off + ln)
                with self._stats_lock:
                    self.stats.coalesced_ranges += 1
            else:
                spans.append((off, off + ln))
        data = {start: self._ranged_get(start, end - start)
                for start, end in spans}
        # gap bytes moved only to merge requests (segments never overlap)
        wasted = max(0, sum(e - s for s, e in spans)
                     - sum(ln for _, ln in order))
        with self._stats_lock:
            self.stats.wasted_bytes += wasted
        out: List[bytes] = []
        for off, ln in ranges:
            if ln == 0:
                out.append(b"")
                continue
            start = next(s for s, e in spans if s <= off and off + ln <= e)
            buf = data[start]
            out.append(buf[off - start:off - start + ln])
        return out

    @property
    def size(self) -> int:
        if self._size is None:
            self._size = self._probe_size()   # benign race: both probes agree
        return self._size

    def close(self) -> None:
        self._closed = True
        self._drop_conn()
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for conn in conns:            # other threads' persistent connections
            conn.close()


@dataclass
class LinkStats:
    """Accounting for a simulated network link."""
    requests: int = 0
    bytes_moved: int = 0
    busy_s: float = 0.0        # time the link spent transferring


class RemoteByteStore(ByteStore):
    """A store on the far side of a modelled network link.

    Every read pays ``latency_s`` of request round-trip (propagation —
    concurrent requests overlap it, like pipelined HTTP range reads) plus
    ``length / bandwidth_bps`` of wire time serialized FIFO over one shared
    link (a lock — bandwidth is not multiplied by issuing requests in
    parallel).  The delay is *real wall time* (``time.sleep``), so overlap
    with compute on other threads is physically measured, not estimated.
    """

    def __init__(self, inner: ByteStore, latency_s: float = 1e-3,
                 bandwidth_bps: float = 400e6):
        self.inner = inner
        self.latency_s = float(latency_s)
        self.bandwidth_bps = float(bandwidth_bps)
        self.stats = LinkStats()
        self._link = threading.Lock()

    def transfer_time(self, length: int) -> float:
        return self.latency_s + length / self.bandwidth_bps

    def read(self, offset: int, length: int) -> bytes:
        _check_range(offset, length, self.inner.size, "remote store")
        time.sleep(self.latency_s)       # round-trip; overlaps across threads
        wire = length / self.bandwidth_bps
        with self._link:                 # one transfer on the wire at a time
            time.sleep(wire)
            self.stats.requests += 1
            self.stats.bytes_moved += length
            self.stats.busy_s += self.latency_s + wire
        return self.inner.read(offset, length)

    @property
    def size(self) -> int:
        return self.inner.size

    def close(self) -> None:
        self.inner.close()
