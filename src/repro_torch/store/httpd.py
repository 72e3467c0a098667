# Copy of repro/store/httpd.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""Stdlib archive endpoint: a ranged-GET HTTP server over container files.

    PYTHONPATH=src python -m repro_torch.store.httpd /data/archive_dir --port 8000
    repro_torch.store.open_archive("http://host:8000/manifest.json")

Serves a directory (sharded archive: ``manifest.json`` + ``*.seg`` blobs) or
a single ``.prs`` file with proper ``Range: bytes=a-b`` semantics — 206 +
``Content-Range`` for satisfiable ranges, 416 for unsatisfiable ones, 200
with the whole resource when no Range header is present — over persistent
HTTP/1.1 connections, so `HTTPByteStore`'s connection reuse actually reuses.

`ThreadingHTTPServer` gives one thread per connection: the SegmentFetcher's
prefetch pool and demand path stream concurrently, like any real object
store.  ``fault_injector`` lets tests inject transient failures (e.g. a 500
on the first attempt) to exercise the client's retry/backoff path.

Every file response (GET and HEAD) carries a weak-validator ``ETag``
derived from ``(size, mtime_ns)``; a conditional GET with a matching
``If-None-Match`` short-circuits to ``304 Not Modified`` — the
revalidation primitive live append-only archives need (`HTTPByteStore`
sends the validator on manifest re-reads, see repro_torch.store.bytestore).

When handed a ``metrics_source`` / ``health_source`` (the serve plane
does), the server also answers ``GET /metrics`` with a plaintext counter
dump and ``GET /health`` with 200/ok — or ``503`` plus a ``Retry-After``
header while the serve plane is shedding load.
"""
from __future__ import annotations

import argparse
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

_RANGE_RE = re.compile(r"bytes=(\d*)-(\d*)$")


def parse_range(header: str, size: int) -> Optional[Tuple[int, int]]:
    """``Range`` header -> (start, end) inclusive, or None if malformed /
    multi-range (caller falls back to the full resource).  Raises ValueError
    for a syntactically valid but unsatisfiable range (-> 416)."""
    m = _RANGE_RE.match(header.strip())
    if not m:
        return None
    first, last = m.group(1), m.group(2)
    if first == "" and last == "":
        return None
    if first == "":                      # suffix form: last N bytes
        n = int(last)
        if n == 0 or size == 0:
            # RFC 9110 §14.1.2: a suffix range on an empty resource (or an
            # empty suffix) is unsatisfiable — (0, -1) would slice garbage
            raise ValueError(
                f"unsatisfiable suffix range {header!r} for size {size}")
        return max(0, size - n), size - 1
    start = int(first)
    end = int(last) if last != "" else size - 1
    if start >= size or end < start:
        raise ValueError(f"unsatisfiable range {header!r} for size {size}")
    return start, min(end, size - 1)


class _ArchiveHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"       # keep-alive: client connections reuse
    server_version = "prstore-httpd/1"
    # the header write + body write per response is exactly the
    # write-write-read pattern where Nagle + the peer's delayed ACK stall
    # every exchange ~40ms; range GETs are latency-bound, so flush eagerly
    disable_nagle_algorithm = True

    def _resolve(self) -> Optional[str]:
        root = self.server.root          # type: ignore[attr-defined]
        name = os.path.basename(self.path.split("?", 1)[0].rstrip("/"))
        if os.path.isfile(root):
            # single-file mode: any request path serves the file
            return root
        path = os.path.realpath(os.path.join(root, name))
        if os.path.commonpath([path, os.path.realpath(root)]) != \
                os.path.realpath(root) or not os.path.isfile(path):
            return None
        return path

    def _respond(self, status: int, length: int,
                 extra: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(length))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()

    def _endpoint(self, head_only: bool) -> bool:
        """Serve /health and /metrics when the server carries sources for
        them; returns True when the request was handled.  Routed before
        file resolution, so an archive file literally named ``metrics``
        is shadowed only on servers that enable the endpoints."""
        route = self.path.split("?", 1)[0].rstrip("/")
        if route == "/metrics":
            source = self.server.metrics_source  # type: ignore[attr-defined]
            if source is None:
                return False
            body = "".join(f"{k} {v:g}\n"
                           for k, v in sorted(source().items()))
            payload = body.encode()
            self._respond(200, len(payload),
                          {"Content-Type": "text/plain; charset=utf-8"})
            if not head_only:
                self.wfile.write(payload)
            return True
        if route == "/health":
            source = self.server.health_source   # type: ignore[attr-defined]
            if source is None:
                return False
            report = source()
            ok = bool(report.get("ok", True))
            extra = {"Content-Type": "text/plain; charset=utf-8"}
            if not ok and report.get("retry_after_s"):
                # shedding: tell well-behaved clients when to come back
                extra["Retry-After"] = \
                    str(max(1, int(report["retry_after_s"])))
            payload = (b"ok\n" if ok else b"overloaded\n")
            self._respond(200 if ok else 503, len(payload), extra)
            if not head_only:
                self.wfile.write(payload)
            return True
        return False

    @staticmethod
    def _etag(path: str) -> str:
        """Weak validator from (size, mtime_ns): changes whenever the file
        is rewritten — exactly the signal a live-archive client needs to
        drop its cached manifest."""
        st = os.stat(path)
        return f'"{st.st_size:x}-{st.st_mtime_ns:x}"'

    def _serve(self, head_only: bool) -> None:
        injector = self.server.fault_injector  # type: ignore[attr-defined]
        if injector is not None:
            status = injector(self)
            if status:
                with self.server.stats_lock:   # type: ignore[attr-defined]
                    self.server.stats["faults"] += 1
                self._respond(status, 0)
                return
        if self._endpoint(head_only):
            return
        path = self._resolve()
        if path is None:
            self._respond(404, 0)
            return
        size = os.path.getsize(path)
        etag = self._etag(path)
        if self._matches(self.headers.get("If-None-Match"), etag):
            with self.server.stats_lock:       # type: ignore[attr-defined]
                self.server.stats["requests"] += 1
                self.server.stats["not_modified"] += 1
            self._respond(304, 0, {"ETag": etag})
            return
        rng_header = self.headers.get("Range")
        rng = None
        if rng_header:
            try:
                rng = parse_range(rng_header, size)
            except ValueError:
                self._respond(416, 0,
                              {"Content-Range": f"bytes */{size}"})
                return
        start, end = rng if rng is not None else (0, size - 1)
        length = end - start + 1 if size else 0
        with self.server.stats_lock:           # type: ignore[attr-defined]
            self.server.stats["requests"] += 1
            self.server.stats["bytes_sent"] += 0 if head_only else length
            if rng is not None:
                self.server.stats["range_requests"] += 1
        extra = {"ETag": etag}
        if rng is not None:
            extra["Content-Range"] = f"bytes {start}-{end}/{size}"
        self._respond(206 if rng is not None else 200, length, extra)
        if head_only or length == 0:
            return
        with open(path, "rb") as fh:
            fh.seek(start)
            remaining = length
            while remaining:
                chunk = fh.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                self.wfile.write(chunk)
                remaining -= len(chunk)

    @staticmethod
    def _parse_etag_list(header: str) -> List[str]:
        """Split an ``If-None-Match`` field value into opaque-tags (quotes
        kept, ``W/`` prefixes stripped).  A naive ``split(",")`` corrupts
        entity-tags that legally contain a comma (RFC 9110 ``etagc``
        permits 0x2C), so the walk is quote-aware: commas only delimit
        between quoted strings."""
        tags, i, n = [], 0, len(header)
        while i < n:
            if header[i] in " \t,":
                i += 1
                continue
            start = i
            if header.startswith("W/", i):
                i += 2
            if i < n and header[i] == '"':
                j = header.find('"', i + 1)
                i = (j + 1) if j != -1 else n
                tags.append(header[start:i])
            else:                        # tolerate unquoted legacy tags
                j = header.find(",", i)
                i = j if j != -1 else n
                tags.append(header[start:i].strip())
        return tags

    @classmethod
    def _matches(cls, if_none_match: Optional[str], etag: str) -> bool:
        """RFC 9110 §13.1.2 weak comparison over a comma-separated
        candidate list; ``*`` matches any current representation.  Weak
        comparison ignores ``W/`` on BOTH sides — a client revalidating
        with a weakened cached tag still gets its 304."""
        if not if_none_match:
            return False
        if if_none_match.strip() == "*":
            return True
        opaque = etag.removeprefix("W/")
        return any(c.removeprefix("W/") == opaque
                   for c in cls._parse_etag_list(if_none_match))

    def do_GET(self) -> None:           # noqa: N802 (http.server API)
        self._serve(head_only=False)

    def do_HEAD(self) -> None:          # noqa: N802
        self._serve(head_only=True)

    def log_message(self, fmt: str, *args) -> None:
        if self.server.verbose:          # type: ignore[attr-defined]
            super().log_message(fmt, *args)


class StoreHTTPServer(ThreadingHTTPServer):
    """Ranged-GET file server for archive containers (tests, demos, and the
    far end of ``open_archive("http://…")``)."""

    daemon_threads = True

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 fault_injector: Optional[
                     Callable[[BaseHTTPRequestHandler], int]] = None,
                 verbose: bool = False,
                 metrics_source: Optional[Callable[[], dict]] = None,
                 health_source: Optional[Callable[[], dict]] = None):
        super().__init__((host, port), _ArchiveHandler)
        self.root = root
        self.fault_injector = fault_injector
        self.verbose = verbose
        # serve-plane observability: /metrics renders the counter dict,
        # /health maps {"ok": bool, "retry_after_s": float} to 200/503
        self.metrics_source = metrics_source
        self.health_source = health_source
        self.stats = {"requests": 0, "range_requests": 0, "bytes_sent": 0,
                      "faults": 0, "not_modified": 0}
        self.stats_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        base = f"http://{host}:{port}/"
        if os.path.isfile(self.root):
            return base + os.path.basename(self.root)
        return base

    def url_for(self, name: str) -> str:
        return f"http://{self.server_address[0]}:{self.server_address[1]}" \
               f"/{name}"

    def start(self) -> "StoreHTTPServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="prstore-httpd", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.server_close()

    def __enter__(self) -> "StoreHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def transient_faults(n: int, status: int = 500,
                     match: str = "") -> Callable:
    """Fault injector failing the first ``n`` matching requests — the shape
    of a flaky object-store frontend; a retrying client must absorb it."""
    remaining = [n]
    lock = threading.Lock()

    def injector(handler: BaseHTTPRequestHandler) -> int:
        if match and match not in handler.path:
            return 0
        with lock:
            if remaining[0] > 0:
                remaining[0] -= 1
                return status
        return 0

    return injector


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve an archive container (file or sharded directory) "
                    "with HTTP range support")
    ap.add_argument("root", help=".prs file or sharded-archive directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    srv = StoreHTTPServer(os.path.abspath(args.root), host=args.host,
                          port=args.port, verbose=args.verbose)
    print(f"[httpd] serving {args.root} at {srv.url}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
