"""Live append-only archives (manifest v4) of the port against the JAX
package, on the CPU.

The scenarios of ``tests/test_live_archive.py`` (follow mode, journal
replay, HTTP conditional GET, retention, sealing, writer validation, a
writer over a static base, concurrent refresh), each run through both
packages and held to the reference: read values and certified bounds bit
for bit, ``bytes_retrieved`` equal, the same timesteps visible and dropped.
Beside them:

* the directory the port's ``ArchiveWriter`` writes (``manifest.json``,
  ``journal.jsonl``, every ``*.t<k>.seg``) byte-identical to the reference
  writer's, before and after ``seal()``;
* each package following the other's live archive while it grows;
* the committed ``tests/fixtures/golden_v4/`` replayed unsealed to
  ``golden_v34_expected.npz``;
* the writer's device policy, ``ensure_archive``'s one-builder race, and
  ``retrieve_qoi_controlled`` over a live session's latest timestep, with
  the fma launches a temperature request makes per iteration.

The port runs with ``device="cpu"`` throughout; its decoded timesteps are
tensors there.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.core import ge as jge  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data.synthetic import ge_like_fields  # noqa: E402
from repro.store import OpenOptions as JaxOpenOptions  # noqa: E402
from repro.store import open_archive as jax_open  # noqa: E402
from repro.store.httpd import StoreHTTPServer as JaxHTTPServer  # noqa: E402
from repro.store.writer import ArchiveWriter as JaxWriter  # noqa: E402
from repro_torch.core import ge  # noqa: E402
from repro_torch.core.refactor import FollowStream, refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.kernels import fma as fma_module  # noqa: E402
from repro_torch.store import (  # noqa: E402
    JOURNAL_NAME,
    ArchiveWriter,
    OpenOptions,
    SegmentCache,
    StoreHTTPServer,
    ensure_archive,
    open_archive,
    save_sharded_archive,
)

CPU = "cpu"
EPS = 1e-3
T_TOTAL = 6
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _frames(n=1 << 9, t=T_TOTAL, seed=0):
    base = ge_like_fields(n=n, seed=seed)["Vx"]
    return [np.asarray(base * (1.0 + 0.05 * k) + 0.01 * np.sin(3.0 * k),
                       dtype=base.dtype)
            for k in range(t)]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


# both packages behind one interface: "jax" is the reference, "torch" the
# port on the CPU
def _create(pkg, directory, **kw):
    if pkg == "jax":
        return JaxWriter.create(directory, **kw)
    return ArchiveWriter.create(directory, device=CPU, **kw)


def _open(pkg, source, **opts):
    if pkg == "jax":
        return jax_open(source, JaxOpenOptions(**opts) if opts else None)
    return open_archive(source, OpenOptions(**opts) if opts else None,
                        device=CPU)


def _write_all(pkg, directory, frames, name="T", keyframe_interval=3, **kw):
    with _create(pkg, directory, keyframe_interval=keyframe_interval,
                 **kw) as w:
        for f in frames:
            w.append({name: f}, eps=EPS)
    return directory


def _dir_bytes(directory) -> dict:
    return {n: open(os.path.join(directory, n), "rb").read()
            for n in sorted(os.listdir(directory))}


def _assert_reads_equal(got, want):
    """Lists of (data, bound): bit-equal data, equal bounds."""
    assert len(got) == len(want)
    for (gd, gb), (wd, wb) in zip(got, want):
        np.testing.assert_array_equal(_bits(gd), _bits(wd))
        assert gb == wb


# ---------------------------------------------------------------------------
# follow mode against one-shot reads
# ---------------------------------------------------------------------------


def _follow_scenario(pkg, live, frames):
    """Append while a session follows; returns the polls, the followed
    reads and bytes, and a fresh one-shot session's reads and bytes."""
    with _create(pkg, live, keyframe_interval=3) as w:
        for f in frames[:2]:
            w.append({"T": f}, eps=EPS)
        st = _open(pkg, live).open()
        stream = st.follow("T")
        polls = [stream.poll()]
        followed = [stream.read(t) for t in (0, 1)]
        for f in frames[2:]:
            w.append({"T": f}, eps=EPS)
        polls += [stream.poll(), stream.poll()]
        latest = stream.latest
        followed += [stream.read(t) for t in range(2, T_TOTAL)]
        followed_bytes = st.bytes_retrieved
    one = _open(pkg, live).open()
    reader = one.reader("T")
    shot = [reader.read(t) for t in range(T_TOTAL)]
    return polls, latest, followed, followed_bytes, shot, \
        one.bytes_retrieved, stream


def test_follow_mode_bit_identical_to_one_shot(tmp_path):
    frames = _frames()
    want = _follow_scenario("jax", str(tmp_path / "j"), frames)
    got = _follow_scenario("torch", str(tmp_path / "t"), frames)
    assert isinstance(got[6], FollowStream)
    assert got[0] == want[0] == [[0, 1], [2, 3, 4, 5], []]
    assert got[1] == want[1] == 5
    _assert_reads_equal(got[2], want[2])
    assert got[3] == want[3]
    # followed reads equal one-shot reads, values, bounds and bytes
    _assert_reads_equal(got[2], got[4])
    assert got[5] == got[3]
    for t, (data, bound) in enumerate(got[4]):
        assert float(np.max(np.abs(data.numpy() - frames[t]))) <= bound


def _refresh_scenario(pkg, live, frames):
    with _create(pkg, live) as w:
        w.append({"A": frames[0]}, eps=EPS)
        sa = _open(pkg, live)
        st = sa.open()
        first = sa.variables["A"].latest_t
        w.append({"A": frames[1], "B": frames[2]}, eps=EPS)
        applied = (sa.refresh(), sa.refresh())
        latest = sa.variables["A"].latest_t
        # a variable journaled after open: session.reader resolves it
        read = st.reader("B").read(0)
        pinned = _open(pkg, live, follow=False)
        static = (sorted(pinned.variables), pinned.refresh())
    return first, applied, latest, read, static


def test_refresh_surfaces_new_variables_and_timesteps(tmp_path):
    frames = _frames(t=3)
    want = _refresh_scenario("jax", str(tmp_path / "j"), frames)
    got = _refresh_scenario("torch", str(tmp_path / "t"), frames)
    assert got[:3] == want[:3]
    assert got[1][0] > 0 and got[1][1] == 0
    _assert_reads_equal([got[3]], [want[3]])
    assert float(np.max(np.abs(got[3][0].numpy() - frames[2]))) <= got[3][1]
    # OpenOptions(follow=False) pins the session to the base manifest
    assert got[4] == want[4] == ([], 0)


def test_journal_write_order_never_exposes_partial_state(tmp_path):
    """A journal torn mid-line (a crashed writer): replay stops at the last
    complete record, in the port as in the reference."""
    frames = _frames(t=3)
    out = {}
    for pkg in ("jax", "torch"):
        live = _write_all(pkg, str(tmp_path / pkg), frames)
        jpath = os.path.join(live, JOURNAL_NAME)
        raw = open(jpath, "rb").read()
        cut = raw.rfind(b"\n", 0, len(raw) - 1) + 1
        with open(jpath, "wb") as fh:
            fh.write(raw[:cut + 10])            # torn final record
        sa = _open(pkg, live)
        latest = sa.variables["T"].latest_t
        out[pkg] = (latest, sa.open().reader("T").read(latest))
    assert out["torch"][0] == out["jax"][0] >= 1
    _assert_reads_equal([out["torch"][1]], [out["jax"][1]])
    data, bound = out["torch"][1]
    assert float(np.max(np.abs(data.numpy() - frames[out["torch"][0]]))) \
        <= bound


# ---------------------------------------------------------------------------
# HTTP follow mode
# ---------------------------------------------------------------------------


def _http_scenario(pkg, live, frames):
    server = JaxHTTPServer if pkg == "jax" else StoreHTTPServer
    with _create(pkg, live, keyframe_interval=3) as w:
        for f in frames[:3]:
            w.append({"T": f}, eps=EPS)
        with server(live) as srv:
            sa = _open(pkg, srv.url_for("manifest.json"))
            st = sa.open()
            stream = st.follow("T")
            polls = [stream.poll()]
            reads = [stream.read(2)]
            stream.poll()
            stream.poll()
            not_modified = srv.stats["not_modified"]
            for f in frames[3:]:
                w.append({"T": f}, eps=EPS)
            polls.append(stream.poll())
            reads.append(stream.read(5))
            sa.close()
    local = _open(pkg, live).open()
    shot = [local.reader("T").read(2), local.reader("T").read(5)]
    return polls, reads, not_modified, shot, \
        (st.bytes_retrieved, local.bytes_retrieved)


def test_http_follow_mode_with_conditional_get(tmp_path):
    frames = _frames()
    want = _http_scenario("jax", str(tmp_path / "j"), frames)
    got = _http_scenario("torch", str(tmp_path / "t"), frames)
    assert got[0] == want[0] == [[0, 1, 2], [3, 4, 5]]
    assert got[2] > 0                   # polls rode the 304 path
    _assert_reads_equal(got[1], want[1])
    # across transports: the followed HTTP reads equal local one-shot ones,
    # bytes included
    _assert_reads_equal(got[1], got[3])
    assert got[4][0] == got[4][1] == want[4][0]
    assert float(np.max(np.abs(got[1][1][0].numpy() - frames[5]))) \
        <= got[1][1][1]


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------


def _retention_state(pkg, live, sa, first, last):
    """What a reader of ``sa`` sees of T: base, keyframe flags, whether the
    timestep before the base raises, the blobs on disk, the retained
    reads."""
    var = sa.variables["T"]
    with pytest.raises(KeyError) as dropped:
        var.handle(var.base_t - 1)
    dropped = "retention" in str(dropped.value)
    blobs = sorted(n for n in os.listdir(live) if n.endswith(".seg"))
    reader = sa.open().reader("T")
    reads = [reader.read(t) for t in range(first, last)]
    return (var.base_t, [h.keyframe for h in var.timesteps], dropped,
            blobs), reads


@pytest.mark.parametrize("interval,retain,steps,base", (
    (3, 4, 8, 3), (4, 2, 7, 4), (1, 3, 7, 4), (2, 9, 4, 0)),
    ids=("drops-head-chains", "boundary-snaps-to-keyframe",
         "keyframe-interval-one", "window-covers-all-steps"))
def test_retention_matches_jax(tmp_path, interval, retain, steps, base):
    """The four retention cases of the reference's suite: the boundary
    snaps down to a keyframe (exactly the target when every step is one),
    dropped timesteps raise KeyError naming retention and leave disk, and
    a window covering every step keeps everything."""
    frames = _frames(t=steps)
    out = {}
    for pkg in ("jax", "torch"):
        live = _write_all(pkg, str(tmp_path / pkg), frames,
                          keyframe_interval=interval,
                          retain_timesteps=retain)
        out[pkg] = _retention_state(pkg, live, _open(pkg, live), base,
                                    steps)
    assert out["torch"][0] == out["jax"][0]
    base_t, keyframes, dropped, blobs = out["torch"][0]
    assert base_t == base and keyframes[0]
    if base:
        assert dropped is True
    assert blobs == [f"T.t{t}.seg" for t in range(base, steps)]
    _assert_reads_equal(out["torch"][1], out["jax"][1])
    for t, (data, bound) in zip(range(base, steps), out["torch"][1]):
        assert float(np.max(np.abs(data.numpy() - frames[t]))) <= bound


def test_retention_applied_by_refresh_in_an_open_session(tmp_path):
    """An archive opened while history is still full drops the head chain
    when a refresh replays the retention record."""
    frames = _frames(t=8)
    out = {}
    for pkg in ("jax", "torch"):
        live = str(tmp_path / pkg)
        with _create(pkg, live, keyframe_interval=3,
                     retain_timesteps=4) as w:
            for i, f in enumerate(frames):
                w.append({"T": f}, eps=EPS)
                if i == 2:
                    sa = _open(pkg, live)
            sa.refresh()
            out[pkg] = _retention_state(pkg, live, sa, 3, 8)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0][0] == 3 and out["torch"][0][2] is True
    _assert_reads_equal(out["torch"][1], out["jax"][1])


# ---------------------------------------------------------------------------
# sealing and the writer's directory
# ---------------------------------------------------------------------------


def test_seal_preserves_bits_and_skips_journal(tmp_path):
    frames = _frames()
    out = {}
    for pkg in ("jax", "torch"):
        live = str(tmp_path / pkg)
        w = _create(pkg, live, keyframe_interval=3)
        for f in frames:
            w.append({"T": f}, eps=EPS)
        live_session = _open(pkg, live).open()
        live_reads = [live_session.reader("T").read(t)
                      for t in range(T_TOTAL)]
        live_bytes = live_session.bytes_retrieved
        w.seal()
        for again in (lambda: w.seal(),
                      lambda: w.append({"T": frames[0]}, eps=EPS)):
            with pytest.raises(ValueError, match="sealed"):
                again()
        manifest = json.loads(open(os.path.join(live, "manifest.json"),
                                   "rb").read())
        assert manifest["sealed"] is True
        sealed = _open(pkg, live)
        assert sealed.refresh() == 0        # consolidated: nothing to replay
        st = sealed.open()
        reads = [st.reader("T").read(t) for t in range(T_TOTAL)]
        _assert_reads_equal(reads, live_reads)
        assert st.bytes_retrieved == live_bytes
        out[pkg] = (reads, live_bytes, _dir_bytes(live))
    _assert_reads_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]


@pytest.mark.parametrize("interval,retain,shape", (
    (3, None, (1 << 9,)), (3, 6, (1 << 9,)), (1, 2, (1 << 9,)),
    (4, None, (9, 10, 11)), (2, 3, (65, 3))),
    ids=("chains", "retention", "all-keyframes", "3-D", "2-D-retention"))
def test_writer_directory_byte_identical(tmp_path, interval, retain, shape):
    """Two variables, 9 timesteps: every file of the directory the port
    writes equals the reference writer's, live and after ``seal()``, with
    the writer's bytes and return values alike."""
    n = int(np.prod(shape))
    frames = [f.reshape(shape) for f in _frames(n=n, t=9)]
    live, sealed, ret = {}, {}, {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        w = _create(pkg, d, keyframe_interval=interval,
                    retain_timesteps=retain)
        ret[pkg] = [w.append({"T": f, "U": 2.0 * f - 1.0}, eps=EPS)
                    for f in frames]
        live[pkg] = _dir_bytes(d)
        ret[pkg].append((w.bytes_written, w.seal()))
        sealed[pkg] = _dir_bytes(d)
    assert ret["torch"] == ret["jax"]
    assert list(live["torch"]) == list(live["jax"])
    for name in live["jax"]:
        assert live["torch"][name] == live["jax"][name], name
    assert sealed["torch"] == sealed["jax"]


@pytest.mark.parametrize("writer,reader", (("torch", "jax"),
                                           ("jax", "torch")),
                         ids=("jax-follows-port", "port-follows-jax"))
def test_each_package_follows_the_others_live_archive(tmp_path, writer,
                                                      reader):
    frames = _frames(t=8)
    live = str(tmp_path / "live")
    with _create(writer, live, keyframe_interval=3,
                 retain_timesteps=5) as w:
        w.append({"T": frames[0]}, eps=EPS)
        st = _open(reader, live).open()
        stream = st.follow("T")
        followed = {}
        for f in frames[1:]:
            w.append({"T": f}, eps=EPS)
            for t in stream.poll():
                followed[t] = stream.read(t)
        assert sorted(followed) == list(range(8))
        follow_bytes = st.bytes_retrieved
    # the writer's own package reading the same directory one-shot
    one = _open(writer, live).open()
    base = one.archive.variables["T"].base_t
    assert base == 3
    shot = [one.reader("T").read(t) for t in range(base, 8)]
    _assert_reads_equal([followed[t] for t in range(base, 8)], shot)
    fresh = _open(reader, live).open()
    again = [fresh.reader("T").read(t) for t in range(base, 8)]
    _assert_reads_equal(again, shot)
    assert fresh.bytes_retrieved == one.bytes_retrieved
    assert follow_bytes >= fresh.bytes_retrieved


def test_writer_validation(tmp_path):
    frames = _frames(t=2)
    for pkg in ("jax", "torch"):
        live = str(tmp_path / pkg)
        with _create(pkg, live) as w:
            w.append({"T": frames[0]}, eps=EPS)
            with pytest.raises(ValueError, match="shape"):
                w.append({"T": frames[0][:17]}, eps=EPS)
            with pytest.raises(ValueError, match="'/'"):
                w.append({"a/b": frames[0]}, eps=EPS)
            with pytest.raises(ValueError, match="at least one"):
                w.append({}, eps=EPS)
        with pytest.raises(FileExistsError):
            _create(pkg, live)
        with pytest.raises(ValueError):
            _create(pkg, str(tmp_path / f"{pkg}-x"), keyframe_interval=0)
        with pytest.raises(ValueError):
            _create(pkg, str(tmp_path / f"{pkg}-y"), retain_timesteps=0)


def test_writer_takes_tensors_and_keeps_its_device(tmp_path):
    """A frame may be a tensor; the chain state stays on the writer's
    device, and the bytes equal those of the same frames as numpy."""
    frames = _frames(t=4)
    for kind in ("numpy", "tensor"):
        with ArchiveWriter.create(str(tmp_path / kind), device=CPU,
                                  keyframe_interval=2) as w:
            assert w.device.type == "cpu"
            for f in frames:
                w.append({"T": torch.from_numpy(f) if kind == "tensor"
                          else f}, eps=EPS)
            assert all(st.prev_recon.device.type == "cpu"
                       for st in w._vars.values())
    assert _dir_bytes(str(tmp_path / "numpy")) == \
        _dir_bytes(str(tmp_path / "tensor"))


def test_writer_over_static_base(tmp_path):
    """create(base=...) journals on top of a static archive: the base's
    bitplane variables and appended timeseries coexist in one manifest, and
    the directory equals the reference's for the same fields."""
    fields = ge_like_fields(n=1 << 9, seed=1)
    frames = _frames(t=2, seed=1)
    out = {}
    for pkg in ("jax", "torch"):
        base = jax_refactor({"Vx": fields["Vx"]}, method="hb") \
            if pkg == "jax" else \
            refactor_variables({"Vx": fields["Vx"]}, method="hb", device=CPU)
        live = str(tmp_path / pkg)
        with _create(pkg, live, base=base) as w:
            with pytest.raises(ValueError, match="exist"):
                w.append({"Vx": frames[0]}, eps=EPS)   # name collision
            w.append({"T": frames[0]}, eps=EPS)
        st = _open(pkg, live).open()
        out[pkg] = (st.reconstruct("Vx", 1e-4), st.reader("T").read(0),
                    _dir_bytes(live))
    _assert_reads_equal(list(out["torch"][:2]), list(out["jax"][:2]))
    assert out["torch"][2] == out["jax"][2]
    data, bound = out["torch"][0]
    assert float(np.max(np.abs(data.numpy() - fields["Vx"]))) <= bound
    data, bound = out["torch"][1]
    assert float(np.max(np.abs(data.numpy() - frames[0]))) <= bound


def test_follow_rejects_non_timeseries():
    fields = ge_like_fields(n=1 << 9, seed=0)
    arch = refactor_variables({"Vx": fields["Vx"]}, method="hb", device=CPU)
    with pytest.raises(ValueError, match="timeseries"):
        arch.open().follow("Vx")


def test_concurrent_refresh_during_reads(tmp_path):
    """A reader hammering read() while another thread appends and applies
    refreshes never fails or mis-decodes, and ends where the reference's
    one-shot read of the same archive does."""
    frames = _frames(t=8)
    live = str(tmp_path / "live")
    with ArchiveWriter.create(live, keyframe_interval=3, device=CPU) as w:
        w.append({"T": frames[0]}, eps=EPS)
        sa = open_archive(live, OpenOptions(cache=SegmentCache()),
                          device=CPU)
        st = sa.open()
        errors = []

        def refresher():
            for f in frames[1:]:
                w.append({"T": f}, eps=EPS)
                sa.refresh()

        thr = threading.Thread(target=refresher)
        thr.start()
        try:
            while thr.is_alive():
                latest = sa.variables["T"].latest_t
                data, bound = st.reader("T").read(latest)
                if float(np.max(np.abs(data.numpy() - frames[latest]))) \
                        > bound:
                    errors.append(latest)
        finally:
            thr.join()
        assert not errors
        sa.refresh()
        got = st.reader("T").read(7)
    want = jax_open(live).open().reader("T").read(7)
    _assert_reads_equal([got], [want])


# ---------------------------------------------------------------------------
# golden fixture, device policy, ensure_archive, retrieval
# ---------------------------------------------------------------------------


def test_golden_v4_replays_unsealed():
    """The committed live archive (written by the reference, unsealed):
    replay reproduces the recorded values, bounds and byte accounting."""
    with np.load(os.path.join(FIXTURES, "golden_v34_expected.npz")) as z:
        want = {k: z[k] for k in z.files}
    with open_archive(os.path.join(FIXTURES, "golden_v4"), device=CPU) as sa:
        assert not sa.sealed
        st = sa.open()
        reader = st.reader("T")
        for t in range(6):
            data, bound = reader.read(t)
            np.testing.assert_array_equal(_bits(data), _bits(want[f"v4__t{t}"]))
            assert bound == float(want[f"v4__bound{t}"])
        assert st.bytes_retrieved == int(want["v4__bytes_retrieved"])
        assert sa.refresh() == 0


def test_writer_raises_without_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArchiveWriter.create(str(tmp_path / "a"))
    assert not os.path.exists(tmp_path / "a")
    with ArchiveWriter.create(str(tmp_path / "b"), device=CPU) as w:
        w.append({"T": _frames(t=1)[0]}, eps=EPS)


def test_ensure_archive_builds_once(tmp_path):
    fields = ge_like_fields(n=1 << 9, seed=0)
    built = []

    def builder():
        built.append(1)
        return refactor_variables({"Vx": fields["Vx"]}, device=CPU)

    target = str(tmp_path / "store")
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        ensure_archive(target, builder, shard_by="variable")))
        for _ in range(4)]
    for thr in threads:
        thr.start()
    for thr in threads:
        thr.join()
    assert sorted(results) == [False, False, False, True]
    assert len(built) == 1
    assert ArchiveWriter.ensure(target, builder, shard_by="variable") is False
    assert not os.path.exists(target + ".lock")
    save_sharded_archive(builder(), str(tmp_path / "direct"))
    assert _dir_bytes(target) == _dir_bytes(str(tmp_path / "direct"))


@pytest.mark.parametrize("tau", (1e-1, 1e-3))
def test_retrieval_over_live_timeseries_matches_jax(tmp_path, tau,
                                                    monkeypatch):
    """``retrieve_qoi_controlled`` on a live session serves each variable's
    latest timestep, as the reference's does: at τ 1e-1 it converges, at
    1e-3 the timestep's fixed bound keeps it unconverged for the loop's 100
    iterations.  Temperature's bound has one fused add, evaluated once per
    iteration and once more for the eps ladder of each iteration that does
    not converge (the count ``chip_smoke.py`` holds the card's launches
    to)."""
    fields = ge_like_fields(n=1 << 10, seed=0)
    frames = [{k: v * (1.0 + 0.05 * t) + 0.01 * np.sin(3.0 * t)
               for k, v in fields.items()} for t in range(3)]
    res = {}
    for pkg in ("jax", "torch"):
        live = str(tmp_path / pkg)
        with _create(pkg, live, keyframe_interval=3) as w:
            for f in frames:
                w.append(f, eps=EPS)
        st = _open(pkg, live).open()
        if pkg == "jax":
            res[pkg] = jax_retrieve(st, [JaxRequest("T", jge.temperature(),
                                                    tau)])
            continue
        calls = []
        real = fma_module.fma
        monkeypatch.setattr(fma_module, "fma",
                            lambda *a: calls.append(1) or real(*a))
        res[pkg] = retrieve_qoi_controlled(
            st, [QoIRequest("T", ge.temperature(), tau)])
    got, want = res["torch"], res["jax"]
    assert got.converged == want.converged == (tau == 1e-1)
    assert [(i.eps, i.bytes_retrieved, i.est_errors, i.tau_abs)
            for i in got.iterations] == \
        [(i.eps, i.bytes_retrieved, i.est_errors, i.tau_abs)
         for i in want.iterations]
    assert got.bytes_retrieved == want.bytes_retrieved
    for k in want.values:
        np.testing.assert_array_equal(_bits(got.values[k]),
                                      _bits(want.values[k]))
    assert len(calls) == 2 * len(got.iterations) - got.converged
