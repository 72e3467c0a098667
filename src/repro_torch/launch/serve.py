"""Concurrent progressive-retrieval service — the paper's serving shape.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --store /data/ge.prs
    PYTHONPATH=src python -m repro_torch.launch.serve --store /data/ge_dir --shard-by variable
    PYTHONPATH=src python -m repro_torch.launch.serve --store http://host:8000/manifest.json
    PYTHONPATH=src python -m repro_torch.launch.serve --n 1048576 --requests 8 \
        --workers 4 --pool-mb 4096 --batch-window-ms 2 --metrics-port 9101
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 8192

Counterpart of ``repro/launch/serve.py``.  It runs on the CUDA device, and
on the CPU only with ``--device cpu`` (``RetrievalServer(device="cpu")``);
without CUDA and without that flag it raises.

The production deployment of Fig 1: data is refactored once into
progressive archives ("storage"); many analysis clients pull
guaranteed-error reconstructions concurrently.  Sessions are sticky, so a
client tightening its tolerance pays only for the new segments (the
incremental-recomposition contract).

Requests run on a bounded worker pool (``repro_torch.serve.pool``) with
per-session locking and load shedding; concurrent duplicate tighten
requests coalesce across sessions into one fetch + one recompose
(``repro_torch.serve.coalesce`` — bit-identical fan-out by the plane-count
invariant); and ``--pool-mb`` replaces the per-variable contribution
budget with ONE server-wide borrow/return pool (``repro_torch.serve.budget``)
so the hottest variables keep their recompose state resident;
``--batch-window-ms`` shares one ``repro_torch.serve.DecodeBatcher``
across sessions, so decodes of one word width flushed within a window run
as one launch of the batched decode kernel.
``--metrics-port`` exposes /health and /metrics (plaintext counters:
queue depth, p50/p99 handle latency, coalesce hits, cache/fetch/
quarantine counters, pool occupancy) on ``repro_torch.store.httpd``.

With ``--store`` the server serves from an archive container (repro_torch.store)
instead of holding the refactored archive in RAM — a local ``.prs`` file
(refactored + saved on first run if missing, exactly once even when two
servers start on the same path: creation is serialized behind a lockfile
and published by atomic rename), a sharded directory (``--shard-by
variable|group``), or an ``http(s)://`` URL of a container / sharded
manifest published by ``repro_torch.store.httpd``.  Segments stream
checksum-verified through the SegmentFetcher (ranged reads + async
prefetch), and a cross-session `SegmentCache` sits under all client
sessions: planes one client already pulled are served from RAM to every
other client instead of re-fetched from the store (``--cache-admission``
additionally skips *inserting* deep-LSB segments under pressure instead
of evicting hot MSB prefixes moments before they are needed again).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bitplane import codecs as plane_codecs
from repro_torch.core import ge
from repro_torch.core.refactor import ContribStats, refactor_variables
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled
from repro_torch.data.synthetic import ge_like_fields
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.options import OpenOptions, SessionOptions
from repro_torch.serve import (ContribBudgetPool, DecodeBatcher,
                               ReconstructCoalescer, ServePlane,
                               ServerOverloadedError)
from repro_torch.store import (BlobQuarantine, RetryPolicy, SegmentCache,
                               open_archive)
from repro_torch.store.container import is_url
from repro_torch.store.httpd import StoreHTTPServer
from repro_torch.store.writer import ensure_archive   # noqa: F401  (re-export,
# as the reference's module is an import path of ensure_archive too)


@dataclass
class Request:
    client: str
    qois: List[str]
    tau: float


class RetrievalServer:
    """Multi-tenant progressive-retrieval server.

    ``contrib_budget_bytes`` caps each session's per-variable contribution
    cache (None = unbounded); ``contrib_pool_bytes`` replaces it with one
    server-wide borrow/return pool (``repro_torch.serve.budget`` — takes
    precedence when both are given).  ``cache_depth_weight`` /
    ``archive_floor_bytes`` tune the cross-session SegmentCache's
    depth-weighted eviction and per-archive working-set floor
    (repro_torch.store.cache); ``cache_admission`` skips inserting colder-than-
    everything segments under pressure instead of churning the cache.
    ``workers`` / ``queue_depth`` size the worker pool and its shedding
    high-water mark; ``coalesce=False`` disables cross-session
    single-flight (benchmark baseline); ``decode_batch_ms`` shares one
    ``DecodeBatcher`` with that window across sessions (None = per-reader
    launches).  Sessions decode on ``device`` (default CUDA; raises without
    it unless ``device="cpu"``)."""

    def __init__(self, fields, method: str = "hb",
                 store_path: Optional[str] = None,
                 shard_by: Optional[str] = None,
                 cache_bytes: int = 256 << 20,
                 cache_depth_weight: float = 64.0,
                 archive_floor_bytes: int = 0,
                 contrib_budget_bytes: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 quarantine: Optional[BlobQuarantine] = None,
                 workers: int = 8,
                 queue_depth: int = 64,
                 contrib_pool_bytes: Optional[int] = None,
                 cache_admission: bool = False,
                 coalesce: bool = True,
                 decode_batch_ms: Optional[float] = None,
                 device: DeviceLike = None):
        import threading
        self.device = resolve_device(device)
        t0 = time.time()
        self.cache: Optional[SegmentCache] = None
        self.contrib_budget_bytes = contrib_budget_bytes
        self.contrib_pool = ContribBudgetPool(contrib_pool_bytes) \
            if contrib_pool_bytes is not None else None
        self.coalescer = ReconstructCoalescer() if coalesce else None
        # one DecodeBatcher shared by every session: concurrent readers'
        # decode / recompose work merges into one launch per shape bucket
        # and tick (None = per-reader launches)
        self.decode_batcher = DecodeBatcher(window_ms=decode_batch_ms) \
            if decode_batch_ms is not None else None
        if store_path is not None:
            ensure_archive(store_path,
                           lambda: refactor_variables(fields, method=method,
                                                      device=self.device),
                           shard_by=shard_by)
            self.cache = SegmentCache(max_bytes=cache_bytes,
                                      depth_weight=cache_depth_weight,
                                      archive_floor_bytes=archive_floor_bytes,
                                      admission_control=cache_admission)
            self.archive = open_archive(
                store_path, OpenOptions.multi_tenant(
                    self.cache, retry_policy=retry_policy,
                    quarantine=quarantine), device=self.device)
            shapes = {k: np.asarray(v).shape for k, v in fields.items()}
            if self.archive.method != method or self.archive.shapes != shapes:
                raise SystemExit(
                    f"store {store_path} holds method="
                    f"{self.archive.method!r} shapes="
                    f"{dict(self.archive.shapes)} but the server was asked "
                    f"for method={method!r} shapes={shapes} — delete the "
                    f"file to re-refactor, or match the flags")
        else:
            self.archive = refactor_variables(fields, method=method,
                                              device=self.device)
        self.sessions: Dict[str, object] = {}
        self._sessions_mu = threading.Lock()
        self.refactor_s = time.time() - t0
        self.qois = ge.all_qois()
        self.plane = ServePlane(self._handle, workers=workers,
                                queue_depth=queue_depth,
                                session_key=lambda req: req.client,
                                decode_batcher=self.decode_batcher)

    # -- request path --------------------------------------------------------

    def _session(self, client: str):
        """Sticky per-client session, created under a lock (two first
        requests of one client may race through the pool)."""
        with self._sessions_mu:
            session = self.sessions.get(client)
            if session is None:
                session = self.archive.open(SessionOptions(
                    contrib_budget_bytes=self.contrib_budget_bytes,
                    contrib_pool=self.contrib_pool,
                    decode_batcher=self.decode_batcher))
                session.coalescer = self.coalescer
                self.sessions[client] = session
        return session

    def _handle(self, req: Request):
        """One request, run inline on the calling thread (the worker body;
        also the sequential baseline the concurrency bench compares
        against).  Per-session serialization is the ServePlane's job."""
        session = self._session(req.client)
        before = session.bytes_retrieved
        reqs = [QoIRequest(q, self.qois[q], req.tau) for q in req.qois]
        t0 = time.time()
        res = retrieve_qoi_controlled(session, reqs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"client": req.client, "tau": req.tau,
                "bytes_moved": session.bytes_retrieved - before,
                "bitrate": res.bitrate, "latency_s": time.time() - t0,
                "guaranteed": res.converged,
                "est_errors": res.est_errors,
                "degraded": res.degraded,
                "availability": res.availability}

    # kept as the documented single-threaded entry point: the concurrency
    # benchmark's sequential baseline, and any embedder that wants to own
    # its own threading
    handle_inline = _handle

    def handle(self, req: Request):
        """Concurrent entry point: submit to the worker pool and wait.
        Raises :class:`repro_torch.serve.ServerOverloadedError` when shedding."""
        return self.plane.handle(req)

    def submit(self, req: Request):
        """Async entry point: a Future, or ServerOverloadedError at the
        door when the pending queue is past the high-water mark."""
        return self.plane.submit(req)

    # -- observability -------------------------------------------------------

    def health(self) -> Dict[str, object]:
        return self.plane.health()

    def metrics(self) -> Dict[str, float]:
        """One flat counter dict for /metrics: pool, coalescer, budget
        pool, segment cache, fetcher (transport + contrib + fault
        counters) — everything a dashboard needs to see a multi-tenant
        server breathe."""
        out = {f"serve_{k}": v for k, v in self.plane.metrics().items()}
        with self._sessions_mu:
            out["serve_sessions_sticky"] = float(len(self.sessions))
        if self.coalescer is not None:
            for k, v in self.coalescer.metrics().items():
                out[f"coalesce_{k}"] = v
        if self.contrib_pool is not None:
            for k, v in self.contrib_pool.metrics().items():
                out[f"pool_{k}"] = v
        if self.decode_batcher is not None:
            for k, v in self.decode_batcher.stats.as_dict().items():
                out[f"batch_{k}"] = v
        if self.cache is not None:
            cs = self.cache.stats
            out.update({
                "cache_hits_total": float(cs.hits),
                "cache_misses_total": float(cs.misses),
                "cache_insertions_total": float(cs.insertions),
                "cache_evictions_total": float(cs.evictions),
                "cache_floor_protected_total": float(cs.floor_protected),
                "cache_admission_skips_total": float(cs.admission_skips),
                "cache_resident_bytes": float(self.cache.nbytes),
            })
        fetcher = getattr(self.archive, "fetcher", None)
        if fetcher is not None:
            st = fetcher.stats
            out.update({
                "fetch_store_reads_total": float(st.store_reads),
                "fetch_cache_hits_total": float(st.cache_hits),
                "fetch_bytes_total": float(st.bytes_fetched),
                "fetch_demand_total": float(st.demand_fetches),
                "fetch_prefetch_hits_total": float(st.prefetch_hits),
                "fetch_retries_total": float(st.retries),
                "fetch_faults_absorbed_total": float(st.faults_absorbed),
                "fetch_quarantined_blobs_total": float(st.quarantined_blobs),
                "contrib_resident_bytes": float(st.contrib_resident_bytes),
                "contrib_peak_bytes": float(st.contrib_peak_bytes),
                "contrib_spills_total": float(st.contrib_spills),
                "contrib_recomputes_total": float(st.contrib_recomputes),
            })
        return out

    def close(self) -> None:
        """Drain the pool, release pooled leases, close the store."""
        self.plane.shutdown(wait=True)
        with self._sessions_mu:
            sessions, self.sessions = dict(self.sessions), {}
        for s in sessions.values():
            close = getattr(s, "close", None)
            if close is not None:
                close()
        if getattr(self.archive, "fetcher", None) is not None:
            self.archive.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 15)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--method", default="hb")
    ap.add_argument("--store", default=None, metavar="PATH_OR_URL",
                    help="serve from an archive container: a .prs path "
                         "(refactor+save first if it does not exist), a "
                         "sharded directory, or an http(s):// URL")
    ap.add_argument("--shard-by", default=None,
                    choices=("variable", "group"),
                    help="when creating a missing --store, write a sharded "
                         "directory (one payload blob per variable / level "
                         "group) instead of a single file")
    ap.add_argument("--workers", type=int, default=8,
                    help="serve-plane worker threads (requests for "
                         "different clients run concurrently; 1 recovers "
                         "the sequential server)")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="max outstanding requests before the server sheds "
                         "load (503 + Retry-After past the high-water mark)")
    ap.add_argument("--pool-mb", type=float, default=None,
                    help="server-wide pooled contribution budget (MiB) "
                         "shared by ALL sessions — replaces --contrib-mb; "
                         "the hottest variables keep their recompose state "
                         "resident (default: off)")
    ap.add_argument("--batch-window-ms", type=float, default=None,
                    help="cross-session decode batching window (ms): "
                         "decode/recompose work of one shape arriving "
                         "within one window runs as one launch "
                         "(bit-identical results; default: off = one "
                         "launch per reader)")
    ap.add_argument("--cache-admission", action="store_true",
                    help="under cache pressure, skip inserting segments "
                         "colder than everything resident (deep-LSB churn "
                         "control) instead of evicting hot MSB prefixes")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose /health and /metrics (plaintext counters) "
                         "on this port")
    ap.add_argument("--cache-mb", type=int, default=256,
                    help="cross-session segment cache budget (MiB)")
    ap.add_argument("--cache-depth-weight", type=float, default=64.0,
                    help="segment-cache eviction bias: recency ticks an MSB "
                         "plane out-lives an LSB plane, per plane of depth "
                         "(0 = plain byte-LRU)")
    ap.add_argument("--archive-floor-mb", type=int, default=0,
                    help="per-archive residency floor (MiB) a hot archive "
                         "cannot evict another archive below")
    ap.add_argument("--contrib-mb", type=float, default=None,
                    help="per-variable contribution-cache budget (MiB) for "
                         "each session's bitplane readers; coarse-level "
                         "fields spill and are recomputed on demand "
                         "(default: unbounded; see --pool-mb for the "
                         "server-wide pooled alternative)")
    ap.add_argument("--retry-attempts", type=int, default=None,
                    help="max fetch attempts per segment, counting the "
                         "first try (default: RetryPolicy's 4; 1 disables "
                         "retries)")
    ap.add_argument("--retry-backoff-ms", type=float, default=None,
                    help="base of the exponential retry backoff, in ms "
                         "(full jitter, capped; default 50)")
    ap.add_argument("--fetch-deadline-s", type=float, default=None,
                    help="wall-clock budget for one segment fetch, all "
                         "attempts included (default 30)")
    ap.add_argument("--quarantine-after", type=int, default=None,
                    help="consecutive failures that quarantine a blob "
                         "(circuit breaker; default: 2x retry attempts)")
    ap.add_argument("--codecs", default=None, metavar="NAME[,NAME...]",
                    help="entropy-stage candidate codecs for refactoring "
                         "(e.g. 'zlib' pins the legacy stand-in; default: "
                         f"{','.join(plane_codecs.DEFAULT_CANDIDATES)}; "
                         "raw is always implied)")
    ap.add_argument("--device", default=None,
                    help="device the sessions decode on (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.codecs is not None:
        plane_codecs.set_default_candidates(
            n for n in args.codecs.split(",") if n)

    fields = ge_like_fields(n=args.n, seed=0)
    contrib_budget = None if args.contrib_mb is None \
        else int(args.contrib_mb * (1 << 20))
    contrib_pool = None if args.pool_mb is None \
        else int(args.pool_mb * (1 << 20))
    retry_policy = None
    if (args.retry_attempts is not None or args.retry_backoff_ms is not None
            or args.fetch_deadline_s is not None):
        base = RetryPolicy()
        retry_policy = RetryPolicy(
            max_attempts=base.max_attempts if args.retry_attempts is None
            else max(1, args.retry_attempts),
            backoff_s=base.backoff_s if args.retry_backoff_ms is None
            else args.retry_backoff_ms / 1e3,
            deadline_s=base.deadline_s if args.fetch_deadline_s is None
            else args.fetch_deadline_s)
    quarantine = None if args.quarantine_after is None \
        else BlobQuarantine(threshold=max(1, args.quarantine_after))
    server = RetrievalServer(fields, method=args.method,
                             store_path=args.store, shard_by=args.shard_by,
                             cache_bytes=args.cache_mb << 20,
                             cache_depth_weight=args.cache_depth_weight,
                             archive_floor_bytes=args.archive_floor_mb << 20,
                             contrib_budget_bytes=contrib_budget,
                             retry_policy=retry_policy,
                             quarantine=quarantine,
                             workers=args.workers,
                             queue_depth=args.queue_depth,
                             contrib_pool_bytes=contrib_pool,
                             cache_admission=args.cache_admission,
                             decode_batch_ms=args.batch_window_ms,
                             device=args.device)
    src = f"store {args.store}" if args.store else "in-memory archive"
    print(f"[server] {src} on {server.device} ready for {args.n} pts x5 "
          f"vars in "
          f"{server.refactor_s:.2f}s "
          f"(archive {server.archive.total_nbytes / 2**20:.2f} MiB); "
          f"{args.workers} workers, queue depth {args.queue_depth}")
    if args.store:
        at_rest = server.archive.codec_bytes()
        print("[server] archive codecs: " + ", ".join(
            f"{name}={nb}B" for name, nb in
            sorted(at_rest.items(), key=lambda kv: -kv[1])))
    httpd = None
    if args.metrics_port is not None:
        root = args.store if args.store and not is_url(args.store) \
            and os.path.exists(args.store) \
            else tempfile.mkdtemp(prefix="repro-metrics-")
        httpd = StoreHTTPServer(os.path.abspath(root),
                                port=args.metrics_port,
                                metrics_source=server.metrics,
                                health_source=server.health).start()
        print(f"[server] /health + /metrics at {httpd.url}")

    rng = np.random.default_rng(0)
    clients = [f"client{i}" for i in range(4)]
    qoi_names = list(ge.all_qois())
    requests = [Request(client=str(rng.choice(clients)),
                        qois=list(rng.choice(qoi_names,
                                             size=rng.integers(1, 4),
                                             replace=False)),
                        tau=float(10.0 ** -rng.integers(1, 6)))
                for _ in range(args.requests)]
    # submit the whole stream through the worker pool, backing off when the
    # server sheds — the shape a well-behaved client fleet has
    futures = []
    for i, req in enumerate(requests):
        while True:
            try:
                futures.append((i, req, server.submit(req)))
                break
            except ServerOverloadedError as e:
                time.sleep(min(e.retry_after_s, 0.25))
    total_bytes = 0
    degraded_vars: Dict[str, object] = {}
    for i, req, fut in futures:
        out = fut.result()
        total_bytes += out["bytes_moved"]
        flag = " DEGRADED" if out["degraded"] else ""
        print(f"[req {i:02d}] {req.client} qois={','.join(req.qois):18s} "
              f"tau={req.tau:.0e} moved={out['bytes_moved']:>9d}B "
              f"lat={out['latency_s'] * 1e3:7.1f}ms ok={out['guaranteed']}"
              f"{flag}")
        if out["degraded"]:
            degraded_vars.update(out["availability"])
    raw = sum(v.nbytes for v in fields.values())
    print(f"[server] total moved {total_bytes / 2**20:.2f} MiB vs raw "
          f"{raw / 2**20:.2f} MiB ({total_bytes / raw:.0%})")
    pm = server.plane.metrics()
    print(f"[server] plane: {pm['requests_total']:.0f} requests on "
          f"{args.workers} workers, p50={pm['latency_p50_ms']:.1f}ms "
          f"p99={pm['latency_p99_ms']:.1f}ms, {pm['shed_total']:.0f} shed")
    if server.coalescer is not None:
        cm = server.coalescer.metrics()
        if cm["hits_total"]:
            print(f"[server] coalesce: {cm['hits_total']:.0f} duplicate "
                  f"requests shared {cm['leaders_total']:.0f} flights "
                  f"({cm['adoptions_total']:.0f} adoptions, "
                  f"{cm['fallbacks_total']:.0f} fallbacks)")
    if degraded_vars:
        print("[server] DEGRADED — some variables are pinned at the deepest "
              "available plane prefix; reported bounds stay certified:")
        for v, a in sorted(degraded_vars.items()):
            print(f"[server]   {v}: achievable eps floor={a.floor:.3e}"
                  + (f" ({a.detail})" if a.detail else ""))
    if args.store:
        fq = server.archive.fetcher
        st = fq.stats
        if st.retries or st.faults_absorbed or st.quarantined_blobs:
            print(f"[server] faults: {st.faults_absorbed} absorbed over "
                  f"{st.retries} retries, "
                  f"{st.quarantined_blobs} blob quarantine trips")
    if args.store:
        st = server.archive.fetcher.stats
        print(f"[server] store: {st.bytes_fetched} segment bytes fetched in "
              f"{st.store_reads} reads, "
              f"{st.demand_fetches} demand / {st.pipelined_hits} pipelined / "
              f"{st.prefetch_hits} predicted (hit rate {st.hit_rate:.0%}), "
              f"blocked {st.demand_wait_s * 1e3:.1f}ms")
        if st.codec_bytes:
            print("[server] wire codecs: " + ", ".join(
                f"{name}={nb}B" for name, nb in
                sorted(st.codec_bytes.items(), key=lambda kv: -kv[1])))
        if server.cache is not None:
            cs = server.cache.stats
            print(f"[server] cache: {st.cache_hits} segment reads served "
                  f"from RAM ({cs.hits} hits / {cs.misses} misses, "
                  f"{server.cache.nbytes / 2**20:.2f} MiB resident, "
                  f"{cs.evictions} evicted, "
                  f"{cs.floor_protected} floor-protected, "
                  f"{cs.admission_skips} admission-skipped)")
    if server.contrib_pool is not None:
        ps = server.contrib_pool.metrics()
        print(f"[server] contrib pool: "
              f"{ps['borrowed_bytes'] / 2**20:.2f} MiB borrowed "
              f"(peak {ps['peak_borrowed_bytes'] / 2**20:.2f} MiB) over "
              f"{ps['leases']:.0f} leases, {ps['denials_total']:.0f} denials"
              f", {ps['reclaims_total']:.0f} reclaims")
    if server.decode_batcher is not None:
        bs = server.decode_batcher.stats.as_dict()
        print(f"[server] decode batching: {bs['decode_items']:.0f} decode + "
              f"{bs['recompose_items']:.0f} recompose items in "
              f"{bs['decode_dispatches'] + bs['recompose_dispatches']:.0f} "
              f"dispatches ({bs['dispatch_ratio']:.1f} items/dispatch)")
    if server.device.type == "cuda":
        print(f"[server] peak device memory "
              f"{torch.cuda.max_memory_allocated(server.device) / 2**30:.2f}"
              f" GiB")
    if args.contrib_mb is not None or args.pool_mb is not None:
        if args.store:
            cst = server.archive.fetcher.stats
        else:                       # in-memory sessions: one sink per reader
            cst = ContribStats()
            for s in server.sessions.values():
                cst.merge(s.contrib_stats())
        print(f"[server] contrib cache: "
              f"{cst.contrib_resident_bytes / 2**20:.2f} MiB resident "
              f"(peak {cst.contrib_peak_bytes / 2**20:.2f} MiB), "
              f"{cst.contrib_spills} spills, "
              f"{cst.contrib_recomputes} recomputes")
    if httpd is not None:
        httpd.stop()
    server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
