"""Worker pool + per-session locking + load shedding for the serve plane.

Counterpart of ``repro/serve/pool.py`` (pure stdlib, copied as it is).

``ServePlane`` fronts a request handler (``RetrievalServer.handle``) with:

  * a bounded thread pool — progressive retrieval is I/O-bound on the
    segment store and the decode / recompose work is queued on the card,
    so threads overlap fetch latency and host work across sessions even
    under the GIL (torch releases it inside its operators);
  * per-session locks — sessions are stateful progressive readers; two
    in-flight requests for the same client must serialize, requests for
    different clients must not;
  * load shedding — admission control at submit: past ``queue_depth``
    outstanding requests the submit raises :class:`ServerOverloadedError`
    carrying a Retry-After estimate (queue drain time at the observed
    service rate), which the HTTP front maps to ``503 Retry-After: n``.
    Shedding at the door keeps tail latency bounded instead of letting
    the queue grow without limit;
  * handle-latency histograms (queue wait + service time) feeding the
    /metrics endpoint's p50/p99 and tail-amplification rows.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional

from repro_torch.serve.metrics import LatencyHistogram


class ServerOverloadedError(RuntimeError):
    """Raised at submit when the pending queue is past the high-water mark.

    ``retry_after_s`` is the server's drain-time estimate — the HTTP front
    sends it as ``Retry-After`` so well-behaved clients back off instead
    of hammering a saturated pool.
    """

    def __init__(self, pending: int, queue_depth: int, retry_after_s: float):
        super().__init__(
            f"serve queue full ({pending}/{queue_depth} outstanding); "
            f"retry after {retry_after_s:.1f}s")
        self.pending = pending
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class ServePlane:
    """Concurrent front for a request handler with per-session locking.

    ``handler(request)`` runs on a worker thread; ``session_key(request)``
    names the sticky session a request belongs to (requests with equal
    keys serialize in submission order, everything else runs in
    parallel).  ``submit`` never blocks: it either enqueues and returns a
    Future or sheds with :class:`ServerOverloadedError`.
    """

    def __init__(self, handler: Callable, workers: int = 8,
                 queue_depth: int = 64,
                 session_key: Optional[Callable] = None,
                 decode_batcher=None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.workers = int(workers)
        self.queue_depth = int(queue_depth)
        # optional serve.DecodeBatcher the handlers share: worker threads
        # flushing decodes within one window merge into a single batched
        # launch (the "batched tick"); kept here so the pool's
        # metrics() reports dispatch coalescing next to queue pressure
        self.decode_batcher = decode_batcher
        self._handler = handler
        self._session_key = session_key or (
            lambda req: getattr(req, "client", None))
        self._executor = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="serve-worker")
        self._mu = threading.Lock()
        self._pending = 0           # submitted, not yet finished
        self._busy = 0              # currently inside a handler
        self._session_locks: Dict[object, threading.Lock] = {}
        self._requests = 0
        self._shed = 0
        self._errors = 0
        self._closed = False
        self.queue_wait = LatencyHistogram()
        self.handle_latency = LatencyHistogram()   # wait + service

    # -- admission --------------------------------------------------------
    def _retry_after(self) -> float:
        """Drain-time estimate: outstanding work / observed service rate."""
        snap = self.handle_latency.snapshot()
        per_req_s = (snap["mean_ms"] / 1e3) if snap["count"] else 0.25
        return max(1.0, self._pending * per_req_s / self.workers)

    def submit(self, request) -> Future:
        with self._mu:
            if self._closed:
                raise RuntimeError("ServePlane is shut down")
            if self._pending >= self.queue_depth:
                self._shed += 1
                raise ServerOverloadedError(self._pending, self.queue_depth,
                                            self._retry_after())
            self._pending += 1
            self._requests += 1
            lock = self._session_locks.setdefault(
                self._session_key(request), threading.Lock())
        submitted = time.perf_counter()
        return self._executor.submit(self._run, request, lock, submitted)

    def handle(self, request):
        """Synchronous convenience: submit + wait (sheds like submit)."""
        return self.submit(request).result()

    # -- worker body ------------------------------------------------------
    def _run(self, request, lock: threading.Lock, submitted: float):
        with lock:          # per-session serialization
            started = time.perf_counter()
            self.queue_wait.observe(started - submitted)
            with self._mu:
                self._busy += 1
            try:
                return self._handler(request)
            except BaseException:
                with self._mu:
                    self._errors += 1
                raise
            finally:
                done = time.perf_counter()
                self.handle_latency.observe(done - submitted)
                with self._mu:
                    self._busy -= 1
                    self._pending -= 1

    # -- observability ----------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Liveness/pressure summary for the /health endpoint."""
        with self._mu:
            pending, shedding = self._pending, \
                self._pending >= self.queue_depth
        return {
            "ok": not shedding,
            "pending": pending,
            "queue_depth": self.queue_depth,
            "retry_after_s": self._retry_after() if shedding else 0.0,
        }

    def metrics(self) -> Dict[str, float]:
        with self._mu:
            out = {
                "workers": float(self.workers),
                "workers_busy": float(self._busy),
                "queue_depth_limit": float(self.queue_depth),
                "queue_depth": float(max(0, self._pending - self._busy)),
                "inflight": float(self._pending),
                "requests_total": float(self._requests),
                "shed_total": float(self._shed),
                "errors_total": float(self._errors),
                "sessions": float(len(self._session_locks)),
            }
        for name, value in self.queue_wait.snapshot().items():
            out[f"queue_wait_{name}"] = value
        for name, value in self.handle_latency.snapshot().items():
            out[f"latency_{name}"] = value
        if self.decode_batcher is not None:
            for name, value in self.decode_batcher.stats.as_dict().items():
                out[f"batch_{name}"] = value
        return out

    def shutdown(self, wait: bool = True) -> None:
        with self._mu:
            self._closed = True
        self._executor.shutdown(wait=wait)

    def __enter__(self) -> "ServePlane":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
