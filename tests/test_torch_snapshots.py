"""The psz3 and psz3_delta snapshot ladders of the port against the JAX
package, on the CPU.

* ``sz_compress`` blobs, code dtypes, ``amax`` and levels byte-equal and
  ``sz_decompress`` bit-equal on 1-D, 2-D and 3-D fields, constant and
  all-zero ones included, at eps from 1e-1 to 1e-12 of the range;
* whole archives of both methods: ``save_archive`` files and both sharded
  layouts byte-identical, each package reading the other's containers;
* ``retrieve_qoi_controlled`` over the six GE QoIs, loose and tight, at
  τ_rel 1e-2 … 1e-9: per-iteration eps, bytes and est_errors identical,
  reconstructions bit-equal;
* store-backed readers: every transport equal to the in-memory session,
  the prefetch rules of ``repro/store/container.py`` and the pinned,
  certified result after a lost snapshot shard, held to the reference;
* ``convert`` carrying a JAX-built archive across.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.compressors import snapshots as jsnap  # noqa: E402
from repro.compressors import szlike as jsz  # noqa: E402
from repro.core import ge as jge  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data.synthetic import smooth_field  # noqa: E402
from repro.store import BlobQuarantine as JaxQuarantine  # noqa: E402
from repro.store import OpenOptions as JaxOpenOptions  # noqa: E402
from repro.store import RetryPolicy as JaxRetryPolicy  # noqa: E402
from repro.store import open_archive as jax_open  # noqa: E402
from repro.store import save_archive as jax_save  # noqa: E402
from repro.store import save_sharded_archive as jax_save_sharded  # noqa: E402
from repro_torch.compressors import snapshots as tsnap  # noqa: E402
from repro_torch.compressors import szlike as tsz  # noqa: E402
from repro_torch.convert import archive_from_arrays, archive_to_arrays  # noqa: E402
from repro_torch.core import ge as tge  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.store import (  # noqa: E402
    BlobQuarantine,
    OpenOptions,
    RetryPolicy,
    StoreHTTPServer,
    memory_store_archive,
    open_archive,
    save_archive,
    save_sharded_archive,
)

CPU = "cpu"
N = 1 << 12
METHODS = ("psz3", "psz3_delta")
SZ_SHAPES = ((1 << 10,), ((1 << 12) + 3,), (17, 33), (65, 3), (9, 10, 11))
SZ_REL_EPS = (1e-1, 1e-3, 1e-6, 1e-9, 1e-12)
GE_QOIS = ("v_total", "mach", "temperature", "total_pressure",
           "sound_speed", "viscosity")
TAUS = (1e-2, 1e-4, 1e-6, 1e-9)
# one session's requests, as chip_smoke.py serves them (loose QoIs)
ROUNDS = ((("VTOT", "v_total", 1e-4), ("Mach", "mach", 1e-4)),
          (("VTOT", "v_total", 1e-6),),
          (("T", "temperature", 1e-5),))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _sz_field(shape, kind: str) -> np.ndarray:
    if kind == "const":
        return np.full(shape, 3.7)
    if kind == "zero":
        return np.zeros(shape)
    return np.random.default_rng(len(shape)).standard_normal(shape) * 10.0


@pytest.fixture(scope="module")
def fields():
    return ge_like_fields(n=N, seed=0)


_ARCHIVES = {}


def _archives(method, fields):
    """(JAX archive, port archive) of the GE fields, built once."""
    if method not in _ARCHIVES:
        _ARCHIVES[method] = (jax_refactor(fields, method=method),
                             refactor_variables(fields, method=method,
                                                device=CPU))
    return _ARCHIVES[method]


def _qoi(pkg, name, tight):
    fn = getattr(pkg, name)
    return fn() if name == "temperature" else fn(tight=tight)


def _rounds(pkg, request_cls):
    return [[request_cls(q, getattr(pkg, f)(), tau) for q, f, tau in reqs]
            for reqs in ROUNDS]


def _assert_results_equal(got, want):
    """Port result against the reference's: decisions identical, values and
    estimates bit for bit."""
    assert got.converged == want.converged
    assert [(i.eps, i.bytes_retrieved, i.est_errors, i.tau_abs)
            for i in got.iterations] == \
        [(i.eps, i.bytes_retrieved, i.est_errors, i.tau_abs)
         for i in want.iterations]
    assert got.bytes_retrieved == want.bytes_retrieved
    assert got.bitrate == want.bitrate
    assert got.achieved_eb == want.achieved_eb
    assert got.est_errors == want.est_errors
    assert got.degraded == want.degraded
    assert {k: (a.pinned, a.floor) for k, a in got.availability.items()} == \
        {k: (a.pinned, a.floor) for k, a in want.availability.items()}
    assert set(got.values) == set(want.values)
    for k in want.values:
        np.testing.assert_array_equal(_bits(got.values[k]),
                                      _bits(want.values[k]))


def _assert_all_equal(got, want):
    for g, w in zip(got, want, strict=True):
        _assert_results_equal(g, w)


def _port_rounds(session):
    return [retrieve_qoi_controlled(session, reqs)
            for reqs in _rounds(tge, QoIRequest)]


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# ------------------------------------------------------------ compressor --


@pytest.mark.parametrize("kind", ("random", "const", "zero"))
@pytest.mark.parametrize("shape", SZ_SHAPES, ids=str)
def test_sz_compress_matches_jax(shape, kind):
    x = _sz_field(shape, kind)
    rng = float(x.max() - x.min()) or 1.0
    for rel in SZ_REL_EPS:
        eps = rel * rng
        want = jsz.sz_compress(x, eps)
        got = tsz.sz_compress(x, eps, device=CPU)
        assert got.blobs == want.blobs, rel
        assert got.dtypes == want.dtypes, rel
        assert (got.amax, got.levels, got.eps) == \
            (want.amax, want.levels, want.eps)
        assert tuple(got.padded_shape) == tuple(want.padded_shape)
        assert got.orig_shape == want.orig_shape
        assert (got.nbytes, got.safe_eps) == (want.nbytes, want.safe_eps)
        dec = tsz.sz_decompress(got, device=CPU)
        assert isinstance(dec, torch.Tensor) and dec.shape == x.shape
        np.testing.assert_array_equal(_bits(dec),
                                      _bits(jsz.sz_decompress(want)))
        assert float((dec - torch.from_numpy(x)).abs().max()) <= got.safe_eps


def test_sz_compress_takes_a_tensor_and_rejects_bad_eps():
    x = _sz_field((65, 3), "random")
    got = tsz.sz_compress(torch.from_numpy(x), 1e-3, device=CPU)
    assert got.blobs == jsz.sz_compress(x, 1e-3).blobs
    with pytest.raises(ValueError, match="positive"):
        tsz.sz_compress(x, 0.0, device=CPU)


# Fault C5: a field whose first, unpredicted value is large against the
# tightest rung (range 0, so the default ladder ends at 1e-10 absolute)
# quantises to codes beyond 2^63.  The reference's ``.astype(np.int64)``
# gives x86's INT64_MIN there, and the port does the same by design, bound
# violation included.
C5_FIELDS = {"const-5e9": np.full((4, 4), 5e9),
             "single-1.3e12": np.array([1.3e12])}
CAST_EDGES = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** 62, -(2.0 ** 63),
                       np.nextafter(2.0 ** 63, 0.0), 2.0 ** 63, -(2.0 ** 64),
                       1e300, -1e300, np.inf, -np.inf, np.nan])


def test_quantise_casts_out_of_range_like_x86():
    """NaN, ±inf and everything outside [-2^63, 2^63) become INT64_MIN, as
    the reference's cast gives on x86; in-range codes cast exactly."""
    with np.errstate(invalid="ignore"):
        want = jsz._quantise(CAST_EDGES, 0.5)
    got = tsz._quantise(torch.from_numpy(CAST_EDGES), 0.5)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[7:] == np.iinfo(np.int64).min).all()


@pytest.mark.parametrize("name", sorted(C5_FIELDS))
def test_int64_overflow_codes_match_jax(name, tmp_path):
    x = C5_FIELDS[name]
    with np.errstate(invalid="ignore"):
        want = jax_refactor({"V": x}, method="psz3")
    got = refactor_variables({"V": x}, method="psz3", device=CPU)
    jax_save(want, str(tmp_path / "jax.prs"))
    save_archive(got, str(tmp_path / "port.prs"))
    assert (tmp_path / "port.prs").read_bytes() == \
        (tmp_path / "jax.prs").read_bytes()
    snaps = got.variables["V"].archive.snapshots
    jst, tst = want.open(), got.open()
    errors = []
    for snap in snaps:
        jd, jb = jst.reconstruct("V", snap.eps)
        td, tb = tst.reconstruct("V", snap.eps)
        np.testing.assert_array_equal(_bits(td), _bits(jd))
        assert tb == jb
        errors.append((float(np.max(np.abs(td.numpy() - x))), tb))
    # the reference's defect, reproduced: the tightest rung is off by the
    # whole value while its reported bound is tiny
    true, bound = errors[-1]
    assert true == float(np.max(np.abs(x))) > bound


def test_ladder_and_selection_match_jax():
    for rng, n in ((1.0, 10), (37.5, 6), (1e-3, 1)):
        assert tsnap.default_snapshot_eps(rng, n=n) == \
            jsnap.default_snapshot_eps(rng, n=n)
    snaps = jsnap.SnapshotArchive.build(
        smooth_field((129,), 1, lo=0.0, hi=1.0),
        jsnap.default_snapshot_eps(1.0, n=5)).snapshots
    for eps in (1.0, 0.1, 0.05, 1e-3, 1e-9):
        assert tsnap.select_snapshot(snaps, eps) == \
            jsnap.select_snapshot(snaps, eps)


@pytest.mark.parametrize("delta", (False, True), ids=("psz3", "psz3_delta"))
def test_snapshot_archive_build_matches_jax(delta):
    x = smooth_field((2049,), 9, lo=-5.0, hi=5.0)
    # a ladder with a duplicate and out of order: sorted and deduplicated
    ladder = jsnap.default_snapshot_eps(10.0, n=6) + [1e-2]
    ladder = ladder[::-1]
    jcls = jsnap.DeltaSnapshotArchive if delta else jsnap.SnapshotArchive
    tcls = tsnap.DeltaSnapshotArchive if delta else tsnap.SnapshotArchive
    want, got = jcls.build(x, ladder), tcls.build(x, ladder, device=CPU)
    assert [s.blobs for s in got.snapshots] == \
        [s.blobs for s in want.snapshots]
    assert [(s.eps, s.amax, s.dtypes) for s in got.snapshots] == \
        [(s.eps, s.amax, s.dtypes) for s in want.snapshots]
    assert got.total_nbytes == want.total_nbytes
    if delta:
        assert got.eps_ladder == want.eps_ladder
    jr, tr = want.open(), got.open(CPU)
    for eps in (1e-1, 1e-3, 1e-2, 1e-5, 1e-9):
        wv, wb = jr.request(eps)
        gv, gb = tr.request(eps)
        assert gb == wb and tr.bytes_fetched == jr.bytes_fetched
        np.testing.assert_array_equal(_bits(gv), _bits(wv))
        assert float((gv - torch.from_numpy(x)).abs().max()) <= gb


@pytest.mark.parametrize("method", METHODS)
def test_readers_never_change_a_returned_tensor(method, fields):
    _, archive = _archives(method, fields)
    session = archive.open()
    loose, _ = session.readers["P"].request(archive.ranges["P"] * 1e-2)
    kept = loose.clone()
    session.readers["P"].request(archive.ranges["P"] * 1e-7)
    np.testing.assert_array_equal(_bits(loose), _bits(kept))


# -------------------------------------------------------------- archives --


@pytest.mark.parametrize("layout", ("single", "variable", "group"))
@pytest.mark.parametrize("method", METHODS)
def test_saved_archives_byte_identical(method, layout, fields, tmp_path):
    jarch, tarch = _archives(method, fields)
    assert tarch.total_nbytes == jarch.total_nbytes
    if layout == "single":
        jax_save(jarch, str(tmp_path / "j.prs"))
        save_archive(tarch, str(tmp_path / "t.prs"))
        assert (tmp_path / "t.prs").read_bytes() == \
            (tmp_path / "j.prs").read_bytes()
        return
    jax_save_sharded(jarch, str(tmp_path / "j"), shard_by=layout)
    save_sharded_archive(tarch, str(tmp_path / "t"), shard_by=layout)
    want = _dir_bytes(str(tmp_path / "j"))
    assert _dir_bytes(str(tmp_path / "t")) == want
    if layout == "group":
        assert "Vz.s9.seg" in want


@pytest.mark.parametrize("method", METHODS)
def test_each_package_reads_the_others_container(method, fields, tmp_path):
    jarch, tarch = _archives(method, fields)
    jax_save_sharded(jarch, str(tmp_path / "j"), shard_by="group")
    save_archive(tarch, str(tmp_path / "t.prs"))
    with open_archive(str(tmp_path / "j"), device=CPU) as ta, \
            jax_open(str(tmp_path / "t.prs")) as ja:
        ts, js = ta.open(), ja.open()
        for eps in (1e-1, 1e-3, 1e-6, 1e-9, 0.0):
            for v in ("Vx", "P"):
                got, gb = ts.reconstruct(v, eps * tarch.ranges[v])
                want, wb = js.reconstruct(v, eps * tarch.ranges[v])
                assert gb == wb
                np.testing.assert_array_equal(_bits(got), _bits(want))
        assert ts.bytes_retrieved == js.bytes_retrieved


# ------------------------------------------------------------- retrieval --


@pytest.mark.parametrize("tight", (False, True), ids=("loose", "tight"))
@pytest.mark.parametrize("method", METHODS)
def test_retrieval_matches_jax(method, tight, fields):
    jarch, tarch = _archives(method, fields)
    js, ts = jarch.open(), tarch.open()
    truth = {q: _qoi(tge, q, tight).value(fields) for q in GE_QOIS}
    for tau in TAUS:
        want = jax_retrieve(js, [JaxRequest(q, _qoi(jge, q, tight), tau)
                                 for q in GE_QOIS])
        got = retrieve_qoi_controlled(ts, [QoIRequest(q, _qoi(tge, q, tight),
                                                      tau)
                                           for q in GE_QOIS])
        _assert_results_equal(got, want)
        for q, est in got.est_errors.items():
            approx = _qoi(tge, q, tight).value(got.values)
            true = float((truth[q] - approx).abs().max())
            assert true <= est
            if got.converged:
                assert est <= got.tau_abs[q]


@pytest.mark.parametrize("method", METHODS)
def test_converted_jax_archive_retrieves_identically(method, fields):
    jarch, tarch = _archives(method, fields)
    layout = {
        "method": jarch.method,
        "shapes": dict(jarch.shapes), "ranges": dict(jarch.ranges),
        "masks": {k: {"mask": m.mask, "values": m.values}
                  for k, m in jarch.masks.items()},
        "variables": {
            name: {"delta": isinstance(v.archive, jsnap.DeltaSnapshotArchive),
                   "eps_ladder": getattr(v.archive, "eps_ladder", None),
                   "snapshots": [{"eps": s.eps, "orig_shape": s.orig_shape,
                                  "padded_shape": s.padded_shape,
                                  "levels": s.levels, "dtypes": s.dtypes,
                                  "amax": s.amax, "blobs": s.blobs}
                                 for s in v.archive.snapshots]}
            for name, v in jarch.variables.items()},
    }
    converted = archive_from_arrays(layout, device=CPU)
    want = [jax_retrieve(js, reqs) for js in [jarch.open()]
            for reqs in _rounds(jge, JaxRequest)]
    _assert_all_equal(_port_rounds(converted.open()), want)
    # and back: the port's own archive through the layout is unchanged
    d = archive_to_arrays(tarch)
    back = archive_to_arrays(archive_from_arrays(d, device=CPU))
    assert back["variables"] == d["variables"]
    assert back["method"] == d["method"] == method


def test_session_seams_take_snapshot_readers(fields):
    _, tarch = _archives("psz3", fields)
    session = tarch.open()
    session.prefetch("Vx", 1e-3)        # in memory: nothing to move
    session.reconstruct("Vx", 1e-3)
    assert session.availability() == {} and not session.degraded
    assert session.contrib_stats().contrib_snapshot() == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="bitplane"):
        session.reconstruct_at_resolution("Vx", 1, 1e-3)


# ----------------------------------------------------------------- store --


def _store_transport(kind, archive, root):
    if kind == "memory-single":
        return memory_store_archive(archive, device=CPU)
    if kind == "memory-group":
        return memory_store_archive(archive, shard_by="group", device=CPU)
    if kind == "file":
        path = os.path.join(root, "a.prs")
        save_archive(archive, path)
        return open_archive(path, device=CPU)
    save_sharded_archive(archive, root, shard_by="variable")
    return open_archive(root, device=CPU)


@pytest.mark.parametrize("transport", ("memory-single", "memory-group",
                                       "file", "dir-variable"))
@pytest.mark.parametrize("method", METHODS)
def test_store_sessions_match_in_memory(method, transport, fields, tmp_path):
    _, tarch = _archives(method, fields)
    want = _port_rounds(tarch.open())
    with _store_transport(transport, tarch, str(tmp_path)) as sa:
        assert sa.method == method
        assert sa.total_nbytes == sum(
            sum(len(b) for b in s.blobs) for v in tarch.variables.values()
            for s in v.archive.snapshots) + sum(
            len(np.packbits(m.mask)) + m.values.nbytes
            for m in tarch.masks.values())
        _assert_all_equal(_port_rounds(sa.open()), want)


@pytest.mark.parametrize("method", METHODS)
def test_store_session_over_http(method, fields, tmp_path):
    _, tarch = _archives(method, fields)
    want = _port_rounds(tarch.open())
    save_sharded_archive(tarch, str(tmp_path), shard_by="group")
    with StoreHTTPServer(str(tmp_path)) as srv:
        with open_archive(srv.url_for("manifest.json"), device=CPU) as sa:
            _assert_all_equal(_port_rounds(sa.open()), want)


def test_snapshot_prefetch_respects_never_go_backwards(fields, tmp_path):
    """A certain hint at a LOOSER eps than an already-decoded snapshot must
    not move a coarser snapshot request() will never decode."""
    _, tarch = _archives("psz3", fields)
    path = str(tmp_path / "a.prs")
    save_archive(tarch, path)
    rng = tarch.ranges["Vx"]
    with open_archive(path, OpenOptions(prefetch_workers=2),
                      device=CPU) as sa:
        st = sa.open()
        st.reconstruct("Vx", 1e-6 * rng)          # tight snapshot decoded
        moved = sa.fetcher.stats.bytes_fetched
        st.prefetch("Vx", 1e-2 * rng)             # looser: a no-op
        sa.fetcher.drain()
        assert sa.fetcher.stats.bytes_fetched == moved
        a, _ = st.reconstruct("Vx", 1e-2 * rng)   # the cached decode
        assert sa.fetcher.stats.bytes_fetched == moved
        b, _ = st.reconstruct("Vx", 1e-6 * rng)
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("method", METHODS)
def test_snapshot_prefetch_hint(method, fields, tmp_path):
    _, tarch = _archives(method, fields)
    path = str(tmp_path / "a.prs")
    save_archive(tarch, path)
    rng = tarch.ranges["Vx"]
    with open_archive(path, OpenOptions(prefetch_workers=2),
                      device=CPU) as sa:
        st = sa.open()
        # psz3 ignores predicted (uncertain) hints; psz3_delta moves the
        # whole prefix either way
        st.prefetch("Vx", 1e-4 * rng, certain=False)
        sa.fetcher.drain()
        uncertain = sa.fetcher.stats.prefetch_issued
        blobs = len(tarch.variables["Vx"].archive.snapshots[0].blobs)
        assert uncertain == (0 if method == "psz3" else 4 * blobs)
        st.prefetch("Vx", 1e-4 * rng)
        sa.fetcher.drain()
        issued = sa.fetcher.stats.prefetch_issued
        assert issued == (blobs if method == "psz3" else 4 * blobs)
        a, _ = st.reconstruct("Vx", 1e-4 * rng)
        assert sa.fetcher.stats.prefetch_hits == issued   # nothing wasted
        b, _ = tarch.open().reconstruct("Vx", 1e-4 * rng)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _open_opts(pkg):
    """No retries and a short quarantine cooldown: a lost shard pins at
    once."""
    if pkg == "jax":
        return JaxOpenOptions(retry_policy=JaxRetryPolicy.none(),
                              quarantine=JaxQuarantine(cooldown_s=0.01,
                                                       cooldown_cap_s=0.05))
    return OpenOptions(retry_policy=RetryPolicy.none(),
                       quarantine=BlobQuarantine(cooldown_s=0.01,
                                                 cooldown_cap_s=0.05))


LOST = 5      # the snapshot whose shard is deleted: Vz.s5.seg
# VTOT at 1e-3 decodes looser rungs only; at 3e-6 every variable's first
# selection is rung 5, eps in (1e-6, 1e-5] of its range
LOST_PLAN = ((("VTOT", "v_total", 1e-3),), (("VTOT", "v_total", 3e-6),),
             (("T", "temperature", 1e-5),))


@pytest.mark.parametrize("method", METHODS)
def test_lost_snapshot_shard_pins_like_jax(method, fields, tmp_path):
    """After Vz.s5.seg is gone: a loose request decodes the looser rungs, a
    tight one pins Vz at the deepest decoded rung with a finite floor and
    stays certified, and the untouched variables stay undegraded — as in
    the reference, result for result."""
    jarch, tarch = _archives(method, fields)
    jax_save_sharded(jarch, str(tmp_path / "j"), shard_by="group")
    save_sharded_archive(tarch, str(tmp_path / "t"), shard_by="group")
    for d in ("j", "t"):
        os.unlink(str(tmp_path / d / f"Vz.s{LOST}.seg"))
    with jax_open(str(tmp_path / "j"), _open_opts("jax")) as ja, \
            open_archive(str(tmp_path / "t"), _open_opts("port"),
                         device=CPU) as ta:
        js, ts = ja.open(), ta.open()
        for i, reqs in enumerate(LOST_PLAN):
            want = jax_retrieve(js, [JaxRequest(q, getattr(jge, f)(), tau)
                                     for q, f, tau in reqs])
            got = retrieve_qoi_controlled(
                ts, [QoIRequest(q, getattr(tge, f)(), tau)
                     for q, f, tau in reqs])
            _assert_results_equal(got, want)
            if i == 0:
                assert got.converged and not got.degraded
                continue
            # pinned in this session from the tight request on
            vz = got.availability["Vz"]
            assert got.degraded and set(got.availability) == {"Vz"}
            assert vz.pinned and math.isfinite(vz.floor)
            assert "s5" in vz.detail or "Vz" in vz.detail
            if i == 1:
                assert not got.converged
                assert got.achieved_eb["Vz"] == vz.floor
                snaps = tarch.variables["Vz"].archive.snapshots
                assert snaps[LOST - 1].eps <= vz.floor < snaps[0].eps * 2
                vt = tge.v_total()
                true = float((vt.value(fields)
                              - vt.value(got.values)).abs().max())
                assert true <= got.est_errors["VTOT"]
            else:
                assert got.converged
    # a fresh session on the untouched variables stays undegraded
    with open_archive(str(tmp_path / "t"), _open_opts("port"),
                      device=CPU) as ta:
        res = retrieve_qoi_controlled(
            ta.open(), [QoIRequest("T", tge.temperature(), 1e-5)])
        assert res.converged and not res.degraded


@pytest.mark.parametrize("method", METHODS)
def test_lost_first_needed_snapshot_raises_like_jax(method, fields, tmp_path):
    """A reader that has decoded nothing has nothing to certify: it re-raises
    instead of pinning."""
    jarch, tarch = _archives(method, fields)
    lost = LOST if method == "psz3" else 0
    jax_save_sharded(jarch, str(tmp_path / "j"), shard_by="group")
    save_sharded_archive(tarch, str(tmp_path / "t"), shard_by="group")
    for d in ("j", "t"):
        os.unlink(str(tmp_path / d / f"Vz.s{lost}.seg"))
    eps = tarch.variables["Vz"].archive.snapshots[lost].eps
    with jax_open(str(tmp_path / "j"), _open_opts("jax")) as ja:
        with pytest.raises(Exception) as jerr:
            ja.open().reconstruct("Vz", eps)
    with open_archive(str(tmp_path / "t"), _open_opts("port"),
                      device=CPU) as ta:
        st = ta.open()
        with pytest.raises(Exception) as terr:
            st.reconstruct("Vz", eps)
        assert type(terr.value).__name__ == type(jerr.value).__name__
        assert st.readers["Vz"].bytes_fetched == 0   # nothing charged
        assert not st.degraded
