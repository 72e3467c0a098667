"""The port's store and fetch plane (``repro_torch.store``) on the CPU:
container round trips over every transport, byte-identity with the JAX
package's containers in both directions, checksums, prefetch, retries,
quarantine and degraded mode.

Every reconstruction through a store is held bit-equal to the in-memory
session on the same archive, at every eps of a ladder.
"""
import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.store import OpenOptions as JaxOpenOptions  # noqa: E402
from repro.store import open_archive as jax_open  # noqa: E402
from repro.store import save_archive as jax_save  # noqa: E402
from repro.store import save_sharded_archive as jax_save_sharded  # noqa: E402
from repro_torch.bitplane.encoder import decode_prefix  # noqa: E402
from repro_torch.bitplane.segments import InMemoryPlaneSource, LevelStream  # noqa: E402
from repro_torch.core import ge  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.store import (  # noqa: E402
    BlobQuarantine,
    ChecksumError,
    FaultInjectingByteStore,
    FaultPlan,
    MemoryByteStore,
    OpenOptions,
    RemoteByteStore,
    RetryPolicy,
    SegmentEntry,
    SegmentFetcher,
    StoreHTTPServer,
    build_container,
    crc32c,
    memory_store_archive,
    open_archive,
    save_archive,
    save_sharded_archive,
)

CPU = "cpu"
N = 1 << 12
EPS_LADDER = (1e-1, 1e-3, 1e-5, 1e-8)
VEL = ("Vx", "Vy", "Vz")


@pytest.fixture(scope="module")
def fields():
    return ge_like_fields(n=N, seed=0)


@pytest.fixture(scope="module")
def archive(fields):
    return refactor_variables(fields, device=CPU)


@pytest.fixture(scope="module")
def jax_archive(fields):
    return jax_refactor(fields, method="hb")


def _bits(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _assert_ladder_equal(store_session, mem_session, names=VEL):
    for eps in EPS_LADDER:
        for v in names:
            a, ba = store_session.reconstruct(v, eps)
            b, bb = mem_session.reconstruct(v, eps)
            np.testing.assert_array_equal(_bits(a), _bits(b))
            assert ba == bb
        assert store_session.bytes_retrieved == mem_session.bytes_retrieved


# ------------------------------------------------------------- transports --
def _open_file(archive, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(archive, path)
    return open_archive(path, device=CPU), None


def _open_sharded(shard_by):
    def opener(archive, tmp_path):
        d = str(tmp_path / "shards")
        save_sharded_archive(archive, d, shard_by=shard_by)
        return open_archive(d, device=CPU), None
    return opener


def _open_memory(shard_by):
    def opener(archive, tmp_path):
        return memory_store_archive(archive, shard_by=shard_by,
                                    device=CPU), None
    return opener


def _open_http_prs(archive, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(archive, path)
    srv = StoreHTTPServer(path).start()
    return open_archive(srv.url, device=CPU), srv


def _open_http_sharded(archive, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded_archive(archive, d, shard_by="variable")
    srv = StoreHTTPServer(d).start()
    return open_archive(srv.url_for("manifest.json"), device=CPU), srv


TRANSPORTS = {
    "file": _open_file,
    "sharded-variable": _open_sharded("variable"),
    "sharded-group": _open_sharded("group"),
    "memory": _open_memory("single"),
    "memory-sharded": _open_memory("variable"),
    "http-prs": _open_http_prs,
    "http-sharded": _open_http_sharded,
}


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_roundtrip_bit_equal_to_in_memory_session(transport, archive,
                                                  tmp_path):
    sa, srv = TRANSPORTS[transport](archive, tmp_path)
    try:
        with sa:
            assert sa.device.type == "cpu"
            assert sa.ranges == archive.ranges
            assert sa.shapes == archive.shapes
            _assert_ladder_equal(sa.open(), archive.open())
    finally:
        if srv is not None:
            srv.stop()


def test_qoi_retrieval_through_http_equals_in_memory(archive, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded_archive(archive, d)
    reqs = [QoIRequest("VTOT", ge.v_total(), 1e-4),
            QoIRequest("Mach", ge.mach(), 1e-4)]
    ref = retrieve_qoi_controlled(archive.open(), reqs)
    with StoreHTTPServer(d) as srv, \
            open_archive(srv.url_for("manifest.json"), device=CPU) as sa:
        session = sa.open()
        res = retrieve_qoi_controlled(session, reqs)
        # FetchStats doubles as the readers' contribution-cache sink
        assert session.contrib_stats().contrib_snapshot() == \
            sa.fetcher.stats.contrib_snapshot()
    assert res.converged and not res.degraded
    assert [(i.eps, i.bytes_retrieved) for i in res.iterations] == \
        [(i.eps, i.bytes_retrieved) for i in ref.iterations]
    assert res.est_errors == ref.est_errors
    for k, v in ref.values.items():
        np.testing.assert_array_equal(_bits(res.values[k]), _bits(v))


# --------------------------------------------- byte-identity with the JAX --
@pytest.mark.parametrize("layout", ["single", "variable", "group"])
def test_containers_byte_identical_to_jax(layout, archive, jax_archive,
                                          tmp_path):
    if layout == "single":
        save_archive(archive, str(tmp_path / "port.prs"))
        jax_save(jax_archive, str(tmp_path / "jax.prs"))
        assert (tmp_path / "port.prs").read_bytes() == \
            (tmp_path / "jax.prs").read_bytes()
        return
    save_sharded_archive(archive, str(tmp_path / "port"), shard_by=layout)
    jax_save_sharded(jax_archive, str(tmp_path / "jax"), shard_by=layout)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_each_package_opens_the_others_container(archive, jax_archive,
                                                 tmp_path):
    save_archive(archive, str(tmp_path / "port.prs"))
    jax_save_sharded(jax_archive, str(tmp_path / "jax"))
    with open_archive(str(tmp_path / "jax"), device=CPU) as port_reads_jax, \
            jax_open(str(tmp_path / "port.prs")) as jax_reads_port:
        ps, js = port_reads_jax.open(), jax_reads_port.open()
        for eps in EPS_LADDER:
            for v in VEL:
                a, ba = ps.reconstruct(v, eps)
                b, bb = js.reconstruct(v, eps)
                np.testing.assert_array_equal(_bits(a), _bits(b))
                assert ba == bb
        assert ps.bytes_retrieved == js.bytes_retrieved


# -------------------------------------------------------------- checksums --
def test_crc32c_vectors():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43


def test_flipped_byte_raises_checksum_error_and_degrades_retrieval(
        archive, fields, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(archive, path)
    with open_archive(path, device=CPU) as sa:
        key, entry = max(((k, e) for k, e in sa.fetcher.index.items()
                          if "/p" in k), key=lambda kv: kv[1].size)
    with open(path, "r+b") as fh:
        fh.seek(entry.offset + entry.size // 2)
        b = fh.read(1)
        fh.seek(entry.offset + entry.size // 2)
        fh.write(bytes([b[0] ^ 0x40]))
    with open_archive(path, device=CPU) as sa:
        with pytest.raises(ChecksumError, match="crc32c"):
            sa.fetcher.fetch(key)
    # through retrieval: the retry budget is spent, the stream pins at the
    # deepest verified prefix, and the session reports a certified result
    var = key.split("/")[0]
    with open_archive(path, OpenOptions(retry_policy=RetryPolicy.none()),
                      device=CPU) as sa:
        st = sa.open()
        data, ach = st.reconstruct(var, 1e-15)
        assert np.max(np.abs(data.numpy() - fields[var])) <= ach
        assert st.degraded
        a = st.availability()[var]
        assert a.pinned and np.isfinite(a.floor) and "crc32c" in a.detail
        assert ach >= a.floor


def test_open_rejects_bad_magic(tmp_path):
    path = str(tmp_path / "bad.prs")
    with open(path, "wb") as fh:
        fh.write(b"NOTASTORE" + struct.pack("<Q", 0))
    with pytest.raises(ValueError, match="magic"):
        open_archive(path, device=CPU)


# --------------------------------------------------------------- prefetch --
def test_prefetch_equals_no_prefetch(archive, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(archive, path)
    rng = np.random.default_rng(7)
    schedule = [(str(rng.choice(VEL)), float(10.0 ** -rng.integers(1, 8)))
                for _ in range(24)]
    with open_archive(path, OpenOptions(prefetch_workers=0),
                      device=CPU) as plain_arch, \
            open_archive(path, OpenOptions(prefetch_workers=3),
                         device=CPU) as pf_arch:
        plain, pf = plain_arch.open(), pf_arch.open()
        for name, eps in schedule:
            pf.prefetch(name, eps / 10.0)       # over-eager hints
            a, ba = plain.reconstruct(name, eps)
            b, bb = pf.reconstruct(name, eps)
            np.testing.assert_array_equal(_bits(a), _bits(b))
            assert ba == bb
            assert plain.bytes_retrieved == pf.bytes_retrieved
        assert pf_arch.fetcher.stats.prefetch_hits > 0


# ---------------------------------------------------- retries, quarantine --
def _tiny_fetcher(n_segments=24, seg_size=4096, workers=0, wrap=None, **kw):
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, n_segments * seg_size,
                           dtype=np.uint8).tobytes()
    index = {}
    for i in range(n_segments):
        seg = payload[i * seg_size:(i + 1) * seg_size]
        index[f"seg{i}"] = SegmentEntry(offset=i * seg_size, size=seg_size,
                                        crc=crc32c(seg))
    store = RemoteByteStore(MemoryByteStore(payload), latency_s=0.0,
                            bandwidth_bps=1e9)
    if wrap is not None:
        store = wrap(store)
    return SegmentFetcher(index, store, prefetch_workers=workers,
                          **kw), payload, seg_size


def test_retry_policy_absorbs_transient_faults():
    plan = FaultPlan(rate=1.0, max_faults_per_range=2)
    fetcher, payload, seg = _tiny_fetcher(
        wrap=lambda s: FaultInjectingByteStore(s, plan, seed=13),
        retry_policy=RetryPolicy(max_attempts=4, backoff_s=1e-4))
    for i in range(6):
        assert fetcher.fetch(f"seg{i}") == payload[i * seg:(i + 1) * seg]
    st = fetcher.stats
    assert st.faults_absorbed == 2 * 6
    assert st.retries >= st.faults_absorbed
    assert st.quarantined_blobs == 0
    fetcher.close()


def test_quarantine_opens_and_reprobes():
    plan = FaultPlan(rate=1.0, max_faults_per_range=2)
    q = BlobQuarantine(threshold=2, cooldown_s=0.01)
    fetcher, payload, seg = _tiny_fetcher(
        wrap=lambda s: FaultInjectingByteStore(s, plan, seed=17),
        quarantine=q)
    with pytest.raises(IOError):
        fetcher.fetch("seg0")
    assert not q.is_quarantined("")
    with pytest.raises(IOError):
        fetcher.fetch("seg0")
    assert q.is_quarantined("")
    assert fetcher.stats.quarantined_blobs == 1
    assert fetcher.fetch("seg0") == payload[0:seg]
    assert not q.is_quarantined("")
    fetcher.close()


def test_faulty_store_retrieval_still_bit_equal(archive):
    """Transient faults under a retry policy change nothing a session
    returns."""
    manifest, payload = build_container(archive)
    faulty = FaultInjectingByteStore(
        MemoryByteStore(payload), FaultPlan(rate=0.3, max_faults_per_range=1),
        seed=5)
    opts = OpenOptions(retry_policy=RetryPolicy(max_attempts=3,
                                                backoff_s=1e-4),
                       blob_resolver=lambda blob: faulty)
    with open_archive(json.loads(json.dumps(manifest)), opts,
                      device=CPU) as fa:
        _assert_ladder_equal(fa.open(), archive.open())
        assert fa.fetcher.stats.faults_absorbed > 0


# ----------------------------------------------------------- degraded mode --
def test_missing_shard_degrades_with_finite_floor(archive, fields, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded_archive(archive, d, shard_by="variable")
    os.unlink(os.path.join(d, "Vz.seg"))
    # a short quarantine cooldown: each lost group's fetch waits out the
    # open circuit's probe, and the default cooldowns add up to a minute
    opts = OpenOptions(prefetch_workers=0,
                       retry_policy=RetryPolicy(max_attempts=2),
                       quarantine=BlobQuarantine(threshold=4, cooldown_s=0.01,
                                                 cooldown_cap_s=0.05))
    with open_archive(d, opts, device=CPU) as sa:
        res = retrieve_qoi_controlled(
            sa.open(), [QoIRequest("VTOT", ge.v_total(), 1e-4)])
        assert res.degraded and not res.converged
        assert set(res.availability) == {"Vz"}
        a = res.availability["Vz"]
        assert a.pinned and np.isfinite(a.floor) and a.floor > 0
        # the reported Vz bound still holds against the truth
        assert np.max(np.abs(res.values["Vz"].numpy() - fields["Vz"])) <= \
            res.achieved_eb["Vz"]
        ok = retrieve_qoi_controlled(
            sa.open(), [QoIRequest("T", ge.temperature(), 1e-5)])
        assert ok.converged and not ok.degraded
        mem = retrieve_qoi_controlled(
            archive.open(), [QoIRequest("T", ge.temperature(), 1e-5)])
        for k, v in mem.values.items():
            np.testing.assert_array_equal(_bits(ok.values[k]), _bits(v))


def test_level_stream_pins_at_the_deliverable_prefix_and_reset_clears_it(
        archive):
    group = archive.variables["Vx"].groups[0]

    class LosesPlane3(InMemoryPlaneSource):
        healed = False
        hints = []

        def planes_available(self, start, stop):
            if self.healed or stop <= 3:
                return super().planes_available(start, stop)
            return list(self.planes(start, 3)), IOError("plane 3 lost")

        def prefetch(self, start, stop, certain=True):
            self.hints.append((start, stop))

    src = LosesPlane3(group)
    s = LevelStream(src, torch.device(CPU))
    assert s.fetch_to_planes(10) > 0
    assert (s.fetched, s.pinned) == (3, 3) and "lost" in str(s.pin_error)
    assert s.fetch_to_planes(20) == 0 and s.fetched == 3
    s.prefetch_to_planes(20)
    assert src.hints == []                 # never speculates past the pin
    src.healed = True
    s.reset()
    assert (s.fetched, s.pinned, s.bytes_fetched) == (0, None, 0)
    s.fetch_to_planes(10)
    assert s.fetched == 10
    assert torch.equal(s.values(), decode_prefix(group, 10, device=CPU))


# --------------------------------------------------------- device policy --
def test_open_archive_raises_without_cuda_unless_cpu(archive, tmp_path,
                                                     monkeypatch):
    path = str(tmp_path / "a.prs")
    save_archive(archive, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_archive(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        memory_store_archive(archive)
    with open_archive(path, device="cpu") as sa:
        assert sa.open().device.type == "cpu"


def test_unported_archives_name_their_roadmap_item():
    """The manifests the port once refused (ROADMAP A9: a journaled one, a
    timeseries variable) now open as the reference opens them: the same
    variables and kinds, an empty timeseries, no journal to replay from a
    manifest dict."""
    base = {"format": "prstore", "version": 3, "method": "hb",
            "ranges": {}, "shapes": {}, "masks": {}, "segments": {}}
    cases = [({"journal": True, "variables": {}}, "A9"),
             ({"variables": {"T": {"kind": "timeseries"}}}, "A9")]
    for extra, item in cases:
        manifest = dict(base, **extra)
        want = jax_open(json.loads(json.dumps(manifest)),
                        JaxOpenOptions(blob_resolver=lambda b: None))
        with open_archive(manifest,
                          OpenOptions(blob_resolver=lambda b: None),
                          device=CPU) as got:
            assert {k: v.kind for k, v in got.variables.items()} == \
                {k: v.kind for k, v in want.variables.items()}, item
            for name, var in got.variables.items():
                assert (var.latest_t, var.base_t) == \
                    (want.variables[name].latest_t,
                     want.variables[name].base_t) == (None, 0)
                with pytest.raises(KeyError, match="no timesteps appended"):
                    got.open().reconstruct(name, 1e-3)
            assert got.refresh() == want.refresh() == 0
            assert got.sealed is want.sealed is False
        want.close()
