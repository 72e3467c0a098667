"""The port's concurrent serve plane on the CPU (``device="cpu"``):
``repro_torch.serve`` (worker pool, load shedding, latency histogram,
pooled contribution budget, request coalescing, decode batching) and
``repro_torch.launch.serve.RetrievalServer``, case for case as
``tests/test_serve_concurrent.py`` holds the JAX package's, and against the
JAX package itself:

  * the server's decisions and bytes (``handle_inline``) equal the
    reference's on the same seeded fields and requests, ``est_errors``
    bit-equal;
  * the batcher's dispatch counts equal the reference's in the
    deterministic straggler case;
  * the batched decode's plain version equals the reference's vmapped
    ``_decode_fused_batch``, and the batched recompose its
    ``scatter_recompose_*_from_batch`` (run under ``jax.jit``), bit for bit,
    on ragged plane counts and with carry-in states;
  * concurrent results (pool + coalescer + batcher + pooled budget) are
    bit-identical to the port's own sequential ones.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.bitplane.encoder import encode_level as jax_encode_level  # noqa: E402
from repro.bitplane.encoder import inflate_planes as jax_inflate  # noqa: E402
from repro.bitplane.encoder import sign_plane_bytes as jax_signs  # noqa: E402
from repro.core.qoi import Var as JaxVar  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import RetrievalServer as JaxServer  # noqa: E402
from repro.serve import DecodeBatcher as JaxBatcher  # noqa: E402
from repro.transform import hierarchical as jhier  # noqa: E402
from repro_torch.bitplane.encoder import (decode_prefix, encode_level,  # noqa: E402
                                          inflate_planes, sign_plane_bytes)
from repro_torch.configs.progressive_retrieval import (  # noqa: E402
    multi_tenant_config)
from repro_torch.core.qoi import Var  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.bitplane_unpack import (bitplane_unpack,  # noqa: E402
                                                 bitplane_unpack_batch)
from repro_torch.kernels.ref import bitplane_unpack_batch_plain  # noqa: E402
from repro_torch.launch.serve import Request, RetrievalServer  # noqa: E402
from repro_torch.options import OpenOptions, SessionOptions  # noqa: E402
from repro_torch.serve import (ContribBudgetPool, DecodeBatcher,  # noqa: E402
                               LatencyHistogram, ReconstructCoalescer,
                               ServePlane, ServerOverloadedError,
                               render_metrics)
from repro_torch.store import (MemoryByteStore, SegmentCache,  # noqa: E402
                               memory_store_archive)
from repro_torch.store.container import (StoreArchive,  # noqa: E402
                                         build_sharded_container)
from repro_torch.store.httpd import StoreHTTPServer  # noqa: E402
from repro_torch.transform import hierarchical as hier  # noqa: E402

CPU = "cpu"


def _vel_fields(n=1 << 10, seed=0):
    fields = ge_like_fields(n=n, seed=seed)
    return {k: fields[k] for k in ("Vx", "Vy", "Vz")}


@pytest.fixture(scope="module")
def vel():
    return _vel_fields()


@pytest.fixture(scope="module")
def hb_archive(vel):
    return refactor_variables(vel, method="hb", device=CPU)


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint64) if a.dtype.itemsize == 8 else a


def _bits_t(t):
    return t.view(torch.int64)


class _GatedStore(MemoryByteStore):
    """A ByteStore whose reads can be blocked on demand — pins a leader
    flight inside its first fetch so waiters deterministically join it.
    The gate starts open (archive and session setup reads pass through)."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.gate = threading.Event()
        self.gate.set()

    def read(self, offset: int, length: int) -> bytes:
        if not self.gate.wait(30):
            raise TimeoutError("gated store never released")
        return super().read(offset, length)


# ------------------------------------------------------------- coalescing --


def test_torch_coalesced_duplicates_fetch_each_segment_once(vel, hb_archive):
    """N concurrent identical tighten requests: one leader flight, N-1
    adoptions, and the store sees exactly the reads one session issues."""
    n_dup, var, eps = 5, "Vx", 1e-5
    with memory_store_archive(hb_archive, device=CPU) as sa:
        s = sa.open(SessionOptions(prefetch_depth=0))
        s.reconstruct(var, eps)
        baseline_reads = sa.fetcher.stats.store_reads

    manifest, payloads = build_sharded_container(hb_archive,
                                                 shard_by="single")
    manifest = json.loads(json.dumps(manifest))
    store = _GatedStore(payloads[""])
    sa = StoreArchive(manifest, store, device=CPU, prefetch_workers=2,
                      cache=SegmentCache())
    coal = ReconstructCoalescer()
    sessions = []
    for _ in range(n_dup):
        s = sa.open(SessionOptions(prefetch_depth=0))
        s.coalescer = coal
        sessions.append(s)
    store.gate.clear()          # now pin the leader's first fetch
    results, errors = [None] * n_dup, []

    def worker(i):
        try:
            results[i] = sessions[i].reconstruct(var, eps)
        except BaseException as exc:   # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_dup)]
    threads[0].start()
    deadline = time.monotonic() + 30
    while coal.metrics()["inflight"] < 1:
        assert time.monotonic() < deadline, "leader flight never appeared"
        time.sleep(0.002)
    for t in threads[1:]:
        t.start()
    while coal.stats.hits < n_dup - 1:
        assert time.monotonic() < deadline, "waiters never joined"
        time.sleep(0.002)
    store.gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert coal.stats.leaders == 1
    assert coal.stats.adoptions == n_dup - 1
    assert coal.stats.fallbacks == 0
    assert sa.fetcher.stats.store_reads == baseline_reads
    ref, ref_bound = results[0]
    for data, bound in results[1:]:
        assert torch.equal(ref, data)
        assert bound == ref_bound
    sa.close()


def test_torch_concurrent_results_bit_identical_to_sequential(vel,
                                                              hb_archive):
    """16 clients (mixed variables and eps, duplicates included) through
    the worker pool + coalescer reconstruct exactly what fresh sequential
    single-client sessions produce."""
    ladder = (1e-2, 1e-6)
    reqs = [(f"c{i}", v, eps) for i, (v, eps) in enumerate(
        (v, e) for e in ladder for v in sorted(vel) for _ in range(3))]
    with memory_store_archive(hb_archive, OpenOptions(cache=SegmentCache()),
                              device=CPU) as sa:
        coal = ReconstructCoalescer()
        sessions = {}
        mu = threading.Lock()

        def handle(req):
            client, var, eps = req
            with mu:
                s = sessions.get(client)
                if s is None:
                    s = sa.open()
                    s.coalescer = coal
                    sessions[client] = s
            return s.reconstruct(var, eps)

        with ServePlane(handle, workers=6, queue_depth=64,
                        session_key=lambda r: r[0]) as plane:
            futs = [plane.submit(r) for r in reqs]
            got = [f.result(120) for f in futs]

    seq = hb_archive.open()
    for (client, var, eps), (data, bound) in zip(reqs, got):
        want, want_bound = seq.reconstruct(var, eps)
        assert torch.equal(want, data), (client, var, eps)
        assert want_bound == bound


def test_torch_coalescer_falls_back_without_serve_hooks(hb_archive):
    """Readers lacking the serve hooks (no state_signature/adopt) still
    work through a coalescer-attached session — counted uncoalescable."""
    coal = ReconstructCoalescer()
    session = hb_archive.open()
    session.coalescer = coal
    reader = session.readers["Vx"]

    class _Legacy:
        def __init__(self, inner):
            self._inner = inner

        def request(self, eps):
            return self._inner.request(eps)
    session.readers["Vx"] = _Legacy(reader)
    data, _ = session.reconstruct("Vx", 1e-3)
    assert coal.stats.uncoalescable == 1
    want, _ = hb_archive.open().reconstruct("Vx", 1e-3)
    assert torch.equal(want, data)


# ---------------------------------------------------- pool + load shedding --


def test_torch_load_shedding_past_high_water():
    gate = threading.Event()
    plane = ServePlane(lambda req: gate.wait(10), workers=1, queue_depth=2)
    try:
        f1 = plane.submit("a")
        f2 = plane.submit("b")
        with pytest.raises(ServerOverloadedError) as ei:
            plane.submit("c")
        assert ei.value.retry_after_s >= 1.0
        assert ei.value.pending == 2 and ei.value.queue_depth == 2
        health = plane.health()
        assert health["ok"] is False and health["retry_after_s"] >= 1.0
        gate.set()
        assert f1.result(10) and f2.result(10)
        m = plane.metrics()
        assert m["shed_total"] == 1 and m["requests_total"] == 2
        assert m["errors_total"] == 0
        assert plane.health()["ok"] is True
    finally:
        plane.shutdown()


def test_torch_per_session_serialization_and_cross_session_parallelism():
    """Same-session requests serialize; different sessions overlap."""
    active = {"n": 0, "max": 0, "overlap_same": False}
    mu = threading.Lock()

    def handler(req):
        session, _ = req
        with mu:
            active["n"] += 1
            active["max"] = max(active["max"], active["n"])
            active.setdefault(session, 0)
            active[session] += 1
            if active[session] > 1:
                active["overlap_same"] = True
        time.sleep(0.02)
        with mu:
            active["n"] -= 1
            active[session] -= 1

    with ServePlane(handler, workers=4, queue_depth=64,
                    session_key=lambda r: r[0]) as plane:
        futs = [plane.submit((f"s{j % 2}", j)) for j in range(8)]
        for f in futs:
            f.result(10)
    assert not active["overlap_same"], \
        "two requests of one session ran concurrently"
    assert active["max"] >= 2, "distinct sessions never overlapped"


def test_torch_plane_rejects_after_shutdown_and_counts_errors():
    plane = ServePlane(lambda req: 1 / 0, workers=1, queue_depth=4)
    fut = plane.submit("x")
    with pytest.raises(ZeroDivisionError):
        fut.result(10)
    assert plane.metrics()["errors_total"] == 1
    plane.shutdown()
    with pytest.raises(RuntimeError):
        plane.submit("y")


def test_torch_latency_histogram_quantiles_and_render():
    h = LatencyHistogram()
    for ms in (1, 1, 1, 1, 2, 2, 5, 5, 20, 400):
        h.observe(ms / 1e3)
    snap = h.snapshot()
    assert snap["count"] == 10
    assert 0.5 <= snap["p50_ms"] <= 3.0
    assert snap["p99_ms"] >= 100
    assert snap["max_ms"] >= 400
    text = render_metrics({"b_total": 2.0, "a_total": 1.0})
    assert text.splitlines() == ["a_total 1", "b_total 2"]


# ------------------------------------------------------ pooled contribution --


class _Owner:
    """Stand-in for a pooled bitplane reader: slot dict + the pool's
    deposit/clear callback."""

    def __init__(self):
        self.slots = {}

    def _pool_set_contrib(self, slot, value):
        if value is None:
            self.slots.pop(slot, None)
        else:
            self.slots[slot] = value


def test_torch_pool_grant_touch_release_accounting():
    pool = ContribBudgetPool(total_bytes=100)
    a = _Owner()
    assert pool.retain(a, slot=0, level=0, nbytes=60, value="x")
    assert a.slots[0] == "x" and pool.holds(a, 0)
    assert pool.borrowed_bytes == 60
    assert pool.retain(a, slot=0, level=0, nbytes=60, value="x2")  # touch
    assert a.slots[0] == "x2" and pool.borrowed_bytes == 60
    assert pool.stats.touches == 1 and pool.stats.grants == 1
    pool.release(a, 0)
    assert not pool.holds(a, 0) and pool.borrowed_bytes == 0
    assert 0 not in a.slots
    assert not pool.retain(a, slot=1, level=0, nbytes=101, value="y")
    assert pool.stats.denials == 1


def test_torch_pool_reclaims_strictly_worse_scored_leases():
    pool = ContribBudgetPool(total_bytes=100, depth_weight=4.0)
    coarse, fine = _Owner(), _Owner()
    assert pool.retain(coarse, slot=5, level=5, nbytes=50, value="c5")
    assert pool.retain(coarse, slot=6, level=6, nbytes=50, value="c6")
    assert pool.retain(fine, slot=0, level=0, nbytes=80, value="f0")
    assert fine.slots[0] == "f0"
    assert not pool.holds(coarse, 6) and 6 not in coarse.slots
    assert pool.stats.reclaims >= 1
    assert pool.borrowed_bytes <= 100


def test_torch_pool_grant_reclaims_multiple_victims_atomically():
    pool = ContribBudgetPool(total_bytes=100, depth_weight=0.0)
    a, b, c = _Owner(), _Owner(), _Owner()
    assert pool.retain(a, slot=0, level=0, nbytes=40, value="a")
    assert pool.retain(b, slot=0, level=0, nbytes=60, value="b")
    assert pool.retain(c, slot=0, level=0, nbytes=95, value="c")
    assert c.slots[0] == "c"
    assert not pool.holds(a, 0) and not pool.holds(b, 0)
    assert a.slots == {} and b.slots == {}
    assert pool.borrowed_bytes == 95
    assert pool.stats.reclaims == 2


def test_torch_pool_denial_never_partially_evicts():
    pool = ContribBudgetPool(total_bytes=100, depth_weight=10.0)
    owners = [_Owner() for _ in range(2)]
    assert pool.retain(owners[0], slot=0, level=0, nbytes=50, value="a")
    assert pool.retain(owners[1], slot=0, level=0, nbytes=50, value="b")
    deep = _Owner()
    assert not pool.retain(deep, slot=0, level=9, nbytes=50, value="c")
    assert pool.holds(owners[0], 0) and pool.holds(owners[1], 0)
    assert owners[0].slots[0] == "a" and owners[1].slots[0] == "b"
    assert deep.slots == {}
    assert pool.stats.denials == 1
    assert pool.stats.reclaims == 0


def test_torch_pooled_budget_bit_identical_and_released_on_close(
        vel, hb_archive):
    """A tiny shared pool forces spills and reclaims across sessions, yet
    every reconstruction matches the unbounded reader bit for bit; closing
    the sessions returns every lease."""
    unbounded = hb_archive.open()
    pool = ContribBudgetPool(total_bytes=64 << 10, depth_weight=4.0)
    with memory_store_archive(hb_archive, device=CPU) as sa:
        s1 = sa.open(SessionOptions.pooled(pool))
        s2 = sa.open(SessionOptions.pooled(pool))
        for eps in (1e-2, 1e-4, 1e-6):
            for v in sorted(vel):
                want, want_bound = unbounded.reconstruct(v, eps)
                for s in (s1, s2):
                    got, bound = s.reconstruct(v, eps)
                    assert torch.equal(want, got), (v, eps)
                    assert bound == want_bound
                assert pool.borrowed_bytes <= pool.total_bytes
        st = sa.fetcher.stats
        assert st.contrib_spills + pool.stats.grants > 0
        assert pool.stats.reclaims > 0
        s1.close()
        s2.close()
    assert pool.borrowed_bytes == 0
    assert pool.metrics()["leases"] == 0


def test_torch_pool_reclaim_inside_one_refresh_rebuilds_the_slot():
    """A pooled reader's own retain of a coarse level can reclaim one of
    its finer slots that this refresh has not summed yet.  A linear field
    has zero surpluses, so its detail groups never move and stay out of the
    refresh's rebuild list; with room for 3 fields, the base group's and
    the next two levels' retains reclaim levels 2, 1 and the base's own
    slot before the sum reaches level 2.  The refresh rebuilds that field
    instead of failing, and the result stays bit-identical."""
    archive = refactor_variables({"P": np.arange(33, dtype=np.float64)},
                                 method="hb", device=CPU)
    var = archive.variables["P"]
    assert [g.exponent is None for g in var.groups] == [True] * 5 + [False]
    pool = ContribBudgetPool(total_bytes=3 * 33 * 8, depth_weight=0.25)
    s = archive.open(SessionOptions.pooled(pool))
    ref = archive.open()
    for eps in (1.0, 1e-3, 1e-9):
        got, bound = s.reconstruct("P", eps)
        want, want_bound = ref.reconstruct("P", eps)
        assert torch.equal(got, want) and bound == want_bound
    assert pool.stats.reclaims >= 6
    assert s.contrib_stats().contrib_recomputes > 0
    s.close()
    assert pool.borrowed_bytes == 0


# ------------------------------------------------------------ /health etc --


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_torch_health_and_metrics_endpoints_under_concurrency(tmp_path):
    """A concurrent RetrievalServer over a real store path, /health and
    /metrics on the port's httpd, 8 concurrent clients: the endpoints
    answer throughout and the counters land."""
    fields = ge_like_fields(n=1 << 10, seed=0)
    path = str(tmp_path / "ge.prs")
    server = RetrievalServer(fields, method="hb", store_path=path,
                             workers=4, queue_depth=32,
                             contrib_pool_bytes=1 << 20,
                             cache_admission=True, decode_batch_ms=2.0,
                             device=CPU)
    httpd = StoreHTTPServer(path, metrics_source=server.metrics,
                            health_source=server.health).start()
    try:
        status, _, body = _get(httpd.url_for("health"))
        assert status == 200 and body == b"ok\n"
        results, errors = [], []

        def client(i):
            try:
                results.append(server.handle(
                    Request(client=f"c{i}", qois=["T"], tau=1e-2)))
            except BaseException as exc:   # noqa: BLE001 - surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        status, _, _ = _get(httpd.url_for("health"))
        assert status in (200, 503)        # alive while under load
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 8
        assert all(r["guaranteed"] for r in results)
        status, headers, body = _get(httpd.url_for("metrics"))
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        metrics = {}
        for line in body.decode().splitlines():
            name, value = line.rsplit(" ", 1)
            metrics[name] = float(value)
        assert metrics["serve_requests_total"] == 8.0
        assert metrics["serve_shed_total"] == 0.0
        assert metrics["serve_latency_count"] == 8.0
        assert metrics["serve_latency_p99_ms"] >= \
            metrics["serve_latency_p50_ms"] > 0
        for key in ("serve_workers", "coalesce_leaders_total",
                    "pool_total_bytes", "cache_hits_total",
                    "fetch_store_reads_total", "contrib_peak_bytes",
                    "batch_decode_items", "serve_batch_decode_items"):
            assert key in metrics, key
        assert metrics["batch_decode_items"] > 0
        names = [ln.rsplit(" ", 1)[0] for ln in body.decode().splitlines()]
        assert names == sorted(names) and len(names) == len(set(names))
    finally:
        httpd.stop()
        server.close()
    assert server.contrib_pool.borrowed_bytes == 0


def test_torch_config_server_kwargs_match_the_server():
    """``PipelineConfig.server_kwargs`` names only RetrievalServer
    parameters, so a config drives the server as it is."""
    import inspect
    cfg = multi_tenant_config()
    params = inspect.signature(RetrievalServer).parameters
    assert set(cfg.server_kwargs()) <= set(params)


# --------------------------------------------------- batched decode ticks --


def test_torch_batched_tick_bit_identical_to_per_reader(vel):
    """Concurrent sessions flushing through ONE shared DecodeBatcher (the
    batched serve tick) reconstruct exactly what per-reader launches
    produce — including a straggler variable whose finest group has a word
    width nothing else has — and the counters prove both routes ran."""
    fields = dict(vel)
    rng = np.random.default_rng(3)
    fields["Wodd"] = rng.standard_normal(1 << 11)
    archive = refactor_variables(fields, method="hb", device=CPU)
    eps = 1e-6
    reqs = [("c0", ("Vx", "Vy", "Vz")), ("c1", ("Vx", "Vy", "Vz")),
            ("c2", ("Vx", "Vy", "Vz")), ("c3", ("Wodd",))]
    bat = DecodeBatcher(window_ms=50.0)
    barrier = threading.Barrier(len(reqs))
    with memory_store_archive(archive, device=CPU) as sa:
        sessions = {c: sa.open(SessionOptions(prefetch_depth=0,
                                              decode_batcher=bat))
                    for c, _ in reqs}

        def handle(req):
            client, names = req
            barrier.wait(10)
            return [sessions[client].reconstruct(v, eps) for v in names]

        with ServePlane(handle, workers=len(reqs), queue_depth=16,
                        session_key=lambda r: r[0],
                        decode_batcher=bat) as plane:
            futs = [plane.submit(r) for r in reqs]
            got = {r[0]: f.result(120) for r, f in zip(reqs, futs)}
            pm = plane.metrics()
    st = bat.stats.as_dict()
    assert st["decode_batched"] >= 2
    assert st["decode_items"] > st["decode_batched"]
    assert st["decode_dispatches"] < st["decode_items"]
    assert st["recompose_batched"] >= 2
    assert pm["batch_decode_items"] == st["decode_items"]
    for client, names in reqs:
        ref = archive.open()
        for (data, bound), v in zip(got[client], names):
            want, want_bound = ref.reconstruct(v, eps)
            assert torch.equal(_bits_t(want), _bits_t(data)), (client, v)
            assert want_bound == bound


def _straggler_stats(batcher_cls, encode, inflate, signs, submit):
    """The reference's deterministic straggler case, with the package's own
    encoder and batcher: two concurrent submissions of unmatchable shapes,
    then two of equal shapes.  Returns the stats and decoded values."""
    rng = np.random.default_rng(5)
    small = encode(rng.standard_normal(40))
    big = encode(rng.standard_normal(400))
    runs = []
    for pair in ((small, big), (big, big)):
        bat = batcher_cls(window_ms=25.0)
        out = [None, None]
        aligned = threading.Barrier(2)

        def job(lbp, i, bat=bat, out=out, aligned=aligned):
            words, shifts = inflate(lbp.count, lbp.nbits, lbp.planes[:17], 0)
            sb = signs(lbp.count, lbp.signs)
            scale = np.float64(2.0) ** (lbp.exponent - lbp.nbits)
            aligned.wait(30)    # both submissions inside one window
            t = submit(bat, words, shifts, sb, scale, lbp.count)
            out[i] = np.asarray(t.result()[1])

        threads = [threading.Thread(target=job, args=(lbp, i))
                   for i, lbp in enumerate(pair)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        runs.append((bat.stats.as_dict(), out, pair))
    return runs


def test_torch_batcher_straggler_shapes_dispatch_solo_as_the_reference():
    """Two concurrent submissions with unmatchable shapes: two solo
    launches and no batched item; two with equal shapes: one batched launch
    covering both — the same counts as the reference's batcher, and values
    bit-equal to a one-shot decode."""
    launches0 = (bitplane_unpack.launches, bitplane_unpack_batch.launches)
    port = _straggler_stats(
        DecodeBatcher, lambda c: encode_level(torch.from_numpy(c)),
        inflate_planes, sign_plane_bytes,
        lambda bat, w, s, sb, sc, n: bat.submit_decode(w, s, None, sb, sc, n,
                                                       torch.device(CPU)))
    ref = _straggler_stats(
        JaxBatcher, jax_encode_level, jax_inflate, jax_signs,
        lambda bat, w, s, sb, sc, n: bat.submit_decode(w, s, None, sb, sc,
                                                       n))
    # ``flushes`` counts drains, which depends on whether the two threads'
    # submissions land in one window; every other counter is fixed by the
    # buckets
    for (st, vals, pair), (jst, jvals, _), (want_batched, want_disp) in zip(
            port, ref, ((0, 2), (2, 1))):
        assert {k: v for k, v in st.items() if k != "flushes"} == \
            {k: v for k, v in jst.items() if k != "flushes"}
        assert st["decode_batched"] == want_batched
        assert st["decode_dispatches"] == want_disp
        for lbp, got, jgot in zip(pair, vals, jvals):
            want = decode_prefix(lbp, 17, device=CPU).numpy()
            assert np.array_equal(want.view(np.uint64), got.view(np.uint64))
            assert np.array_equal(got.view(np.uint64), jgot.view(np.uint64))
    # the CPU runs the plain versions: no kernel launch was counted
    assert (bitplane_unpack.launches,
            bitplane_unpack_batch.launches) == launches0


def test_torch_batcher_error_reaches_every_waiter():
    """A failing bucket's error reaches each of its waiters, and a bucket
    that did not fail still delivers."""
    bat = DecodeBatcher(window_ms=1000.0)
    words = np.zeros((1, 2), dtype=np.uint32)
    sb = np.zeros(8, dtype=np.uint8)
    good = bat.submit_decode(words, [3], None, sb, 1.0, 64, torch.device(CPU))
    bad = [bat.submit_decode(np.zeros((1, 1), np.uint32), [3], None,
                             np.zeros(4, np.uint8), 1.0, 32,
                             torch.device(CPU)) for _ in range(2)]
    for t in bad:     # a shift past 63 fails the batched bucket's check
        t.payload[0][1][0] = 64
    assert bat.flush() == 1
    for t in bad:
        with pytest.raises(ValueError, match="shifts"):
            t.result()
    mag, vals = good.result()
    assert mag.shape == (64,) and vals.shape == (64,)
    assert bat.stats.decode_items == 3


def test_torch_batcher_hammer_loses_no_items():
    """16 threads x 20 decodes through one DecodeBatcher with a 0.5 ms
    window and a 10 us thread switch interval: every item is decoded once,
    bit-equal to its solo decode, and the counters add up exactly."""
    import sys
    rng = np.random.default_rng(11)
    n_threads, n_items = 16, 20
    jobs = []
    for _ in range(n_threads * n_items):
        nwords = int(rng.integers(1, 4))
        p = int(rng.integers(0, 9))
        words = rng.integers(0, 2 ** 32, (p, nwords), dtype=np.uint64) \
            .astype(np.uint32)
        shifts = np.arange(47, 47 - p, -1, dtype=np.int64)
        sb = rng.integers(0, 256, nwords * 4, dtype=np.uint8)
        jobs.append((words, shifts, sb, nwords * 32 - int(rng.integers(0, 8))))
    bat = DecodeBatcher(window_ms=0.5)
    out = [None] * len(jobs)
    start = threading.Barrier(n_threads)

    def worker(tid):
        start.wait(30)
        for i in range(tid, len(jobs), n_threads):
            words, shifts, sb, count = jobs[i]
            out[i] = bat.submit_decode(words, shifts, None, sb, 2.0 ** -30,
                                       count, torch.device(CPU)).result()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    st = bat.stats.as_dict()
    assert st["decode_items"] == len(jobs)
    assert st["decode_batched"] <= st["decode_items"]
    assert st["decode_dispatches"] <= st["decode_items"]
    for (words, shifts, sb, count), (mag, vals) in zip(jobs, out):
        want = ops.decode_values_fused(words, shifts, None, sb, 2.0 ** -30,
                                       count, torch.device(CPU))
        assert torch.equal(mag, want[0])
        assert torch.equal(_bits_t(vals), _bits_t(want[1]))


# -------------------------------------------- batched kernels vs the JAX one --


def _ragged_items(rng, nwords, planes, carry):
    """Decode inputs of one word width with ragged plane counts: per item
    (words (P, W) uint32, shifts (P,) descending runs or holes, state or
    None, sign bytes, scale)."""
    items = []
    for k, p in enumerate(planes):
        words = rng.integers(0, 2 ** 32, (p, nwords), dtype=np.uint64) \
            .astype(np.uint32)
        if k % 2:
            shifts = rng.permutation(64)[:p].astype(np.int64)
        else:
            top = 47 if p <= 48 else 63
            shifts = np.arange(top, top - p, -1, dtype=np.int64)
        state = rng.integers(0, 2 ** 62, nwords * 32, dtype=np.int64) \
            if carry[k] else None
        sb = rng.integers(0, 256, nwords * 4, dtype=np.uint8)
        items.append((words, shifts, state, sb, 2.0 ** -(20 + k)))
    return items


@pytest.mark.parametrize("nwords", (1, 3, 64, 70))
def test_torch_batch_decode_plain_matches_jax_decode_fused_batch(nwords):
    """``bitplane_unpack_batch`` (its plain version on the CPU) against the
    reference's vmapped ``_decode_fused_batch`` on the batcher's padded
    layout (64 plane slots, zero planes): B in {1, 2, 3, 8}, ragged plane
    counts, with and without carry-in states — bit for bit, and bit-equal
    to the solo plain decode of each item."""
    rng = np.random.default_rng(nwords)
    for planes in ((17,), (1, 48), (0, 33, 64), (5, 31, 32, 1, 48, 2, 0, 9)):
        carry = [bool(rng.integers(0, 2)) for _ in planes]
        carry[0] = True
        if len(planes) > 1:
            carry[1] = False
        items = _ragged_items(rng, nwords, planes, carry)
        count = nwords * 32
        prepared = [jops.prepare_fused_decode(w, s, st, sb, count, 64)
                    for w, s, st, sb, _ in items]
        stack = [jnp.stack([p[i] for p in prepared]) for i in range(4)]
        jmag, jvals = jops._decode_fused_batch(
            *stack, jnp.asarray([it[4] for it in items], jnp.float64))
        inputs = [ops.prepare_fused_decode(w, s, st, sb, count,
                                           torch.device(CPU))
                  for w, s, st, sb, _ in items]
        got = bitplane_unpack_batch(*zip(*inputs), [it[4] for it in items])
        plain = bitplane_unpack_batch_plain(*zip(*inputs),
                                            [it[4] for it in items])
        for b, ((mag, vals), (pm, pv)) in enumerate(zip(got, plain)):
            assert np.array_equal(mag.numpy().view(np.uint64),
                                  np.asarray(jmag[b])), (planes, b)
            assert np.array_equal(_bits(vals), _bits(jvals[b])), (planes, b)
            assert torch.equal(mag, pm) and torch.equal(_bits_t(vals),
                                                        _bits_t(pv))
            w, sh, st, sb = inputs[b]
            smag, svals = bitplane_unpack(w, sh, st, sb, items[b][4])
            assert torch.equal(mag, smag)
            assert torch.equal(_bits_t(vals), _bits_t(svals))
        fused = ops.decode_values_fused_batch(
            inputs, [it[4] for it in items], [count - 5] * len(items))
        assert all(v.shape == (count - 5,) for _, v in fused)


def test_torch_batch_decode_rejects_mixed_word_widths():
    a = torch.zeros((1, 2), dtype=torch.int32)
    b = torch.zeros((1, 3), dtype=torch.int32)
    s = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="word width"):
        bitplane_unpack_batch([a, b], [s, s], [None, None], [None, None],
                              [1.0, 1.0])
    assert bitplane_unpack_batch([], [], [], [], []) == []


@pytest.mark.parametrize("shape", ((33,), (9, 17), (5, 9, 9)))
def test_torch_batched_recompose_matches_jax(shape):
    """``scatter_recompose_from_batch`` and its ip form against the
    reference's vmapped graphs under ``jax.jit``, and against the solo port
    functions slice by slice, bit for bit."""
    rng = np.random.default_rng(len(shape))
    levels = hier.grid_levels(shape)
    lmap = hier.level_map(shape, levels).ravel()
    for l in range(levels + 1):
        idx = np.flatnonzero(lmap == l)
        start = min(l, levels - 1)
        vals = rng.standard_normal((4, idx.size)) * 2.0 ** rng.integers(
            -8, 8, (4, 1))
        idx_b = np.broadcast_to(idx, (4, idx.size)).copy()
        quanta = np.array([0.0, 2.0 ** -3, 2.0 ** -10, 1.0])
        jout = jax.jit(jhier.scatter_recompose_from_batch,
                       static_argnums=(2, 3, 4))(
            jnp.asarray(idx_b), jnp.asarray(vals), shape, levels, start)
        jip = jax.jit(jhier.scatter_recompose_ip_from_batch,
                      static_argnums=(2, 3, 4))(
            jnp.asarray(idx_b), jnp.asarray(vals), shape, levels, start,
            jnp.asarray(quanta))
        ti, tv = torch.from_numpy(idx_b), torch.from_numpy(vals)
        out = hier.scatter_recompose_from_batch(ti, tv, shape, levels, start)
        ip = hier.scatter_recompose_ip_from_batch(ti, tv, shape, levels,
                                                  start,
                                                  torch.from_numpy(quanta))
        assert np.array_equal(_bits(out), _bits(jout)), l
        assert np.array_equal(_bits(ip), _bits(jip)), l
        for b in range(4):
            solo = hier.scatter_recompose_from(ti[b], tv[b], shape, levels,
                                               start)
            solo_ip = hier.scatter_recompose_ip_from(
                ti[b], tv[b], shape, levels, start, float(quanta[b]))
            assert torch.equal(_bits_t(out[b]), _bits_t(solo))
            assert torch.equal(_bits_t(ip[b]), _bits_t(solo_ip))


# -------------------------------------------------- the server vs the JAX one --

PARITY_REQUESTS = (("c0", ("VTOT", "Mach"), 1e-4), ("c1", ("VTOT", "Mach"), 1e-4),
                   ("c2", ("VTOT",), 1e-6), ("c3", ("T",), 1e-5),
                   ("c4", ("W",), 1e-5), ("c0", ("VTOT",), 1e-6),
                   ("c1", ("VTOT",), 1e-6), ("c2", ("PT", "mu"), 1e-3))


@pytest.fixture(scope="module")
def parity_fields():
    fields = ge_like_fields(n=1 << 12, seed=0)
    # a straggler variable: twice the points, so its groups' word widths
    # match no other variable's
    fields["Wodd"] = np.random.default_rng(3).standard_normal(1 << 13)
    return fields


def _same_result(got, want, where):
    for key in ("bytes_moved", "bitrate", "guaranteed", "degraded"):
        assert got[key] == want[key], (where, key)
    assert sorted(got["est_errors"]) == sorted(want["est_errors"]), where
    for q, e in want["est_errors"].items():
        assert np.float64(got["est_errors"][q]).view(np.uint64) == \
            np.float64(e).view(np.uint64), (where, q)


def test_torch_server_handle_inline_matches_jax_package(parity_fields):
    """The port's RetrievalServer and the reference's, sequentially
    (``handle_inline``) on the same seeded fields and requests: equal bytes
    moved, bitrate and guarantee, est_errors bit-equal."""
    jserver = JaxServer(parity_fields, method="hb", workers=1)
    server = RetrievalServer(parity_fields, method="hb", workers=1,
                             device=CPU)
    jserver.qois["W"] = JaxVar("Wodd")
    server.qois["W"] = Var("Wodd")
    try:
        for client, qois, tau in PARITY_REQUESTS:
            want = jserver.handle_inline(JaxRequest(client, list(qois), tau))
            got = server.handle_inline(Request(client, list(qois), tau))
            _same_result(got, want, (client, qois, tau))
    finally:
        jserver.close()
        server.close()


def _recons(server, client):
    """The reconstruction each reader of a client's session holds now."""
    return {v: r._recon for v, r in server.sessions[client].readers.items()
            if getattr(r, "_recon", None) is not None}


def test_torch_server_concurrent_matches_its_sequential_run(parity_fields):
    """Pool + coalescer + batcher + pooled budget, requests submitted
    concurrently in two rounds, against a sequential server without any of
    them: equal results and bit-equal reconstructions; leases returned on
    close."""
    rounds = (PARITY_REQUESTS[:5], PARITY_REQUESTS[5:])
    seq = RetrievalServer(parity_fields, method="hb", workers=1,
                          coalesce=False, device=CPU)
    conc = RetrievalServer(parity_fields, method="hb", workers=4,
                           contrib_pool_bytes=1 << 18, decode_batch_ms=20.0,
                           device=CPU)
    for s in (seq, conc):
        s.qois["W"] = Var("Wodd")
    try:
        for reqs in rounds:
            want = [seq.handle_inline(Request(c, list(q), t))
                    for c, q, t in reqs]
            futs = [conc.submit(Request(c, list(q), t)) for c, q, t in reqs]
            got = [f.result(120) for f in futs]
            for (c, q, t), g, w in zip(reqs, got, want):
                _same_result(g, w, (c, q, t))
            for c in {c for c, _, _ in reqs}:
                wr, gr = _recons(seq, c), _recons(conc, c)
                assert sorted(wr) == sorted(gr)
                for v in wr:
                    assert torch.equal(_bits_t(wr[v]), _bits_t(gr[v])), \
                        (c, v)
        m = conc.metrics()
        assert m["serve_requests_total"] == len(PARITY_REQUESTS)
        assert m["serve_shed_total"] == 0
        assert m["batch_decode_items"] > 0
        assert m["pool_peak_borrowed_bytes"] <= 1 << 18
    finally:
        seq.close()
        conc.close()
    assert conc.contrib_pool.borrowed_bytes == 0
