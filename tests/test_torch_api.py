"""The port's public surface (ROADMAP A11) against the JAX package's: the
lazy top-level API, every subpackage's exports, the option presets, the
legacy-kwargs shim at each of its call sites, the host decoders
(``bitplane.decode_magnitudes`` / ``decode_values``), the NYX and S3D
stand-in fields and unverified opens.  The two pipeline examples are
held to the reference in ``tests/test_torch_examples.py``.

``pytest.ini`` escalates only the JAX package's deprecation warning, so
these tests escalate the port's own ``ReproDeprecationWarning`` where they
need it to be an error.
"""
import importlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.bitplane import encoder as jenc  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.bitplane import encoder as tenc  # noqa: E402
from repro_torch.core import refactor as trefactor  # noqa: E402
from repro_torch.core.refactor import RetrievalSession, refactor_variables  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.options import (  # noqa: E402
    OpenOptions,
    ReproDeprecationWarning,
    SessionOptions,
    _reset_deprecation_warnings,
)
from repro_torch.store import (  # noqa: E402
    ArchiveWriter,
    ChecksumError,
    SegmentCache,
    memory_store_archive,
    open_archive,
    save_archive,
)
from repro_torch.store import container as tcontainer  # noqa: E402

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("", "core", "bitplane", "transform", "data", "store",
               "compressors", "configs", "serve", "kernels")


def _bits(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.fixture(scope="module")
def fields():
    return ge_like_fields(n=1 << 10, seed=0)


@pytest.fixture(scope="module")
def hb(fields):
    return refactor_variables(fields, method="hb", device=CPU)


@pytest.fixture(scope="module")
def psz3(fields):
    return refactor_variables({"Vx": fields["Vx"]}, method="psz3",
                              device=CPU)


@pytest.fixture
def escalated():
    """The port's deprecation warning as an error, with the warn-once set
    cleared before and after."""
    _reset_deprecation_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReproDeprecationWarning)
        yield
    _reset_deprecation_warnings()


def _tiny_archive():
    return refactor_variables({"Vx": ge_like_fields(n=1 << 8, seed=0)["Vx"]},
                              method="hb", device=CPU)


# ---------------------------------------------------------------------------
# mirrors of tests/test_live_archive.py: presets, shim, top-level API
# ---------------------------------------------------------------------------


def test_open_options_presets():
    cache = SegmentCache()
    from repro_torch.store.retry import BlobQuarantine, RetryPolicy
    mt = OpenOptions.multi_tenant(cache, retry_policy=RetryPolicy.none(),
                                  quarantine=BlobQuarantine())
    assert mt.cache is cache and mt.retry_policy is not None
    assert OpenOptions.unverified().verify is False
    assert OpenOptions.default().prefetch_workers == 2
    assert mt.with_(prefetch_workers=7).prefetch_workers == 7
    assert mt.with_(prefetch_workers=7).cache is cache
    with pytest.raises(TypeError):
        OpenOptions(bogus=1)
    # the presets are the reference's, field for field
    for name in ("default", "unverified"):
        assert (getattr(OpenOptions, name)().__dict__
                == getattr(repro.OpenOptions, name)().__dict__)


def test_session_options_presets():
    assert SessionOptions.memory_bounded(123).contrib_budget_bytes == 123
    assert SessionOptions.default().prefetch_depth == 1
    assert SessionOptions.default().with_(prefetch_depth=3).prefetch_depth \
        == 3
    with pytest.raises(TypeError):
        SessionOptions(bogus=1)
    assert (SessionOptions.default().__dict__
            == repro.SessionOptions.default().__dict__)


def test_legacy_kwargs_warn_once_then_stay_quiet(tmp_path):
    _reset_deprecation_warnings()
    arch = _tiny_archive()
    path = str(tmp_path / "a.prs")
    repro_torch.save_archive(arch, path)
    with pytest.warns(ReproDeprecationWarning, match="OpenOptions"):
        sa = open_archive(path, verify=False, device=CPU)
    assert sa.fetcher.verify is False
    sa.close()
    # second use of the SAME legacy signature: silent (warn-once)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReproDeprecationWarning)
        open_archive(path, device=CPU, verify=False).close()
    _reset_deprecation_warnings()


def test_legacy_session_kwargs_route_through_shim():
    _reset_deprecation_warnings()
    arch = _tiny_archive()
    with pytest.warns(ReproDeprecationWarning, match="SessionOptions"):
        st = arch.open(contrib_budget_bytes=1 << 16)
    assert st.options.contrib_budget_bytes == 1 << 16
    _reset_deprecation_warnings()


def test_mixing_options_and_legacy_kwargs_raises(tmp_path):
    arch = _tiny_archive()
    path = str(tmp_path / "a.prs")
    repro_torch.save_archive(arch, path)
    with pytest.raises(TypeError, match="both"):
        open_archive(path, OpenOptions.default(), verify=False, device=CPU)
    with pytest.raises(TypeError, match="both"):
        arch.open(SessionOptions.default(), prefetch_depth=0)
    with pytest.raises(TypeError):
        open_archive(path, definitely_not_a_kwarg=1, device=CPU)


def test_top_level_api_resolves():
    """Every name repro_torch.__all__ promises resolves lazily, the list is
    the reference's, and the canonical spellings are the deep imports."""
    assert repro_torch.__all__ == repro.__all__
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    from repro_torch.store.container import open_archive as deep_open
    assert repro_torch.open is deep_open
    assert repro_torch.open_archive is deep_open
    assert repro_torch.refactor is refactor_variables
    assert repro_torch.ArchiveWriter is ArchiveWriter
    assert repro_torch.OpenOptions is OpenOptions
    assert repro_torch.ReproDeprecationWarning is ReproDeprecationWarning
    assert repro_torch.RetrievalSession is RetrievalSession
    assert set(repro_torch.__all__) <= set(dir(repro_torch))
    with pytest.raises(AttributeError):
        repro_torch.not_a_thing


# ---------------------------------------------------------------------------
# the shim at every call site of the reference
# ---------------------------------------------------------------------------


def _reader_summary(reader):
    dev = getattr(reader, "device", None) or reader.reader.device
    return (type(reader), dev, getattr(reader, "_resident_cap", None))


def _live_var(tmp_path):
    d = str(tmp_path / "live")
    w = ArchiveWriter.create(d, device=CPU)
    w.append({"T": np.linspace(0.0, 1.0, 64)}, eps=1e-3)
    sa = open_archive(d, device=CPU)
    return sa, sa.variables["T"]


SESSION_LEGACY = {"contrib_budget_bytes": 4096, "prefetch_depth": 0}
OPEN_LEGACY = {"verify": False, "prefetch_workers": 0}


def _site(name, hb, psz3, tmp_path):
    """(call(options, **legacy), summary(result), options class, cleanup)
    for one shimmed API of the port."""
    closers = []

    def store(archive):
        sa = memory_store_archive(archive, device=CPU)
        closers.append(sa.close)
        return sa

    def reader(var):
        return (lambda o=None, **kw: var.open_reader(o, device=CPU, **kw),
                _reader_summary, SessionOptions)

    def session_options(s):
        return s.options

    def open_summary(sa):
        closers.append(sa.close)
        pool = sa.fetcher._pool
        return (sa.fetcher.verify, pool._max_workers if pool else 0,
                sa.device, sorted(sa.variables))

    if name == "_resolve_session_options":
        site = (lambda o=None, **kw: trefactor._resolve_session_options(
            o, kw, "site"), lambda r: r, SessionOptions)
    elif name == "_resolve_open_options":
        site = (lambda o=None, **kw: tcontainer._resolve_open_options(
            o, kw, "site"), lambda r: r, OpenOptions)
    elif name == "BitplaneVarArchive.open_reader":
        site = reader(hb.variables["Vx"])
    elif name == "SnapshotVarArchive.open_reader":
        site = reader(psz3.variables["Vx"])
    elif name == "Archive.open":
        site = (lambda o=None, **kw: hb.open(o, **kw), session_options,
                SessionOptions)
    elif name == "RetrievalSession.__init__":
        site = (lambda o=None, **kw: RetrievalSession(hb, o, **kw),
                session_options, SessionOptions)
    elif name == "StoreBitplaneVar.open_reader":
        site = reader(store(hb).variables["Vx"])
    elif name == "StoreSnapshotVar.open_reader":
        site = reader(store(psz3).variables["Vx"])
    elif name == "StoreTimeseriesVar.open_reader":
        sa, var = _live_var(tmp_path)
        closers.append(sa.close)
        site = reader(var)
    elif name == "StoreArchive.open":
        sa = store(hb)
        site = (lambda o=None, **kw: sa.open(o, **kw), session_options,
                SessionOptions)
    elif name == "open_archive":
        path = str(tmp_path / "a.prs")
        save_archive(hb, path)
        site = (lambda o=None, **kw: open_archive(path, o, device=CPU, **kw),
                open_summary, OpenOptions)
    else:
        assert name == "memory_store_archive"
        site = (lambda o=None, **kw: memory_store_archive(hb, o, device=CPU,
                                                          **kw),
                open_summary, OpenOptions)
    return site, closers


SHIM_SITES = ("_resolve_session_options", "BitplaneVarArchive.open_reader",
              "SnapshotVarArchive.open_reader", "Archive.open",
              "RetrievalSession.__init__", "StoreBitplaneVar.open_reader",
              "StoreSnapshotVar.open_reader", "StoreTimeseriesVar.open_reader",
              "StoreArchive.open", "_resolve_open_options", "open_archive",
              "memory_store_archive")


@pytest.mark.parametrize("name", SHIM_SITES)
def test_every_shim_site_warns_once_equals_options_and_rejects(
        name, hb, psz3, tmp_path):
    (call, summary, cls), closers = _site(name, hb, psz3, tmp_path)
    legacy = SESSION_LEGACY if cls is SessionOptions else OPEN_LEGACY
    try:
        _reset_deprecation_warnings()
        # the legacy spelling warns once, naming the options class
        with pytest.warns(ReproDeprecationWarning,
                          match=cls.__name__) as rec:
            got = summary(call(**legacy))
        assert len([w for w in rec
                    if w.category is ReproDeprecationWarning]) == 1
        with warnings.catch_warnings():
            warnings.simplefilter("error", ReproDeprecationWarning)
            again = summary(call(**legacy))
            # ... and behaves as the options object
            want = summary(call(cls(**legacy)))
            default = summary(call())
        assert got == want == again
        if cls is SessionOptions and name.endswith("open_reader") and \
                "Bitplane" in name:
            assert got != default          # the budget reached the reader
        # mixing the spellings raises; so does an unknown name
        with pytest.raises(TypeError, match="not both"):
            call(cls(), **legacy)
        with pytest.raises(TypeError, match="unexpected"):
            call(definitely_not_an_option=1)
    finally:
        _reset_deprecation_warnings()
        for close in closers:
            close()


def test_device_is_a_keyword_not_a_legacy_option(hb, tmp_path, escalated):
    path = str(tmp_path / "a.prs")
    save_archive(hb, path)
    with open_archive(path, device=CPU) as sa:
        assert sa.device.type == "cpu"
        assert sa.variables["Vx"].open_reader(device=CPU).device.type \
            == "cpu"
    with memory_store_archive(hb, shard_by="variable", device=CPU) as sa:
        assert sa.device.type == "cpu"


def test_main_path_raises_no_deprecation_when_escalated(fields, tmp_path,
                                                         escalated):
    """refactor -> save -> open -> session -> memory_store_archive, the
    live writer and the serve plane's server, with the port's warning an
    error: no first-party code uses the legacy spelling."""
    from repro_torch.core import QoIRequest, ge, retrieve_qoi_controlled
    from repro_torch.launch.serve import Request, RetrievalServer
    archive = repro_torch.refactor(fields, method="hb", device=CPU)
    path = str(tmp_path / "ge.prs")
    repro_torch.save_archive(archive, path)
    reqs = [QoIRequest("VTOT", ge.v_total(), 1e-4)]
    with repro_torch.open(path, repro_torch.OpenOptions.default(),
                          device=CPU) as a:
        s = a.open(repro_torch.SessionOptions.memory_bounded(64 << 20))
        res = retrieve_qoi_controlled(s, reqs)
    with memory_store_archive(archive, device=CPU) as ma:
        res2 = retrieve_qoi_controlled(ma.open(), reqs)
    ref = retrieve_qoi_controlled(archive.open(), reqs)
    for r in (res, res2):
        assert r.bytes_retrieved == ref.bytes_retrieved
        for k in ref.values:
            np.testing.assert_array_equal(_bits(r.values[k]),
                                          _bits(ref.values[k]))
    w = repro_torch.ArchiveWriter.create(str(tmp_path / "live"), device=CPU)
    w.append({"T": fields["P"] / fields["D"]}, eps=1e-3)
    stream = repro_torch.open(str(tmp_path / "live"), device=CPU).open() \
        .follow("T")
    assert stream.poll() == [0]
    w.seal()
    server = RetrievalServer(fields, device=CPU)
    try:
        out = server.handle_inline(Request("c0", ["VTOT"], 1e-3))
        assert out["guaranteed"] and not out["degraded"]
    finally:
        server.close()


# ---------------------------------------------------------------------------
# exports: every reference name resolves on the port
# ---------------------------------------------------------------------------


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    # no __all__: the functions and classes the module itself defines
    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_") and callable(v)
                  and getattr(v, "__module__", None) == mod.__name__)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_cover_the_reference(sub):
    suffix = f".{sub}" if sub else ""
    ref = importlib.import_module(f"repro{suffix}")
    port = importlib.import_module(f"repro_torch{suffix}")
    names = _public_names(ref)
    for name in names:
        assert getattr(port, name) is not None, f"repro_torch{suffix}.{name}"
    if hasattr(ref, "__all__"):
        assert set(ref.__all__) <= set(port.__all__)
    if not sub:
        assert port.__all__ == ref.__all__


def test_bare_import_pulls_in_neither_torch_nor_the_codec():
    code = ("import sys\n"
            "for m in ('jax', 'repro', 'triton'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m == 'torch' or m.startswith('repro_torch')))\n"
            "repro_torch.OpenOptions.default()\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m == 'torch' or m.startswith('repro_torch')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bare, options = out.stdout.splitlines()
    assert bare == "['repro_torch']"
    # the options module needs neither torch nor any codec module
    assert options == "['repro_torch', 'repro_torch.options']"


def _port_modules():
    pkg = REPO / "src" / "repro_torch"
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .replace(".__init__", "")
        for p in pkg.rglob("*.py"))


@pytest.fixture(scope="module")
def alone_imports():
    """Each module of the port imported first, on its own: one process
    that drops every ``repro_torch`` module before each import, so no
    import order of another module can hide a cycle."""
    code = ("import importlib, json, sys, traceback\n"
            "for m in ('jax', 'repro', 'triton'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "out = {}\n"
            f"for m in {_port_modules()!r}:\n"
            "    for k in [k for k in sys.modules\n"
            "              if k.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[k]\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "        out[m] = ''\n"
            "    except BaseException:\n"
            "        out[m] = traceback.format_exc()\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("sub", [s for s in SUBPACKAGES if s]
                         + ["launch", "models", "train"])
def test_each_subpackage_imports_alone(sub, alone_imports):
    mods = [m for m in alone_imports
            if m == f"repro_torch.{sub}"
            or m.startswith(f"repro_torch.{sub}.")]
    assert mods
    for m in mods:
        assert alone_imports[m] == "", alone_imports[m]


# ---------------------------------------------------------------------------
# host decoders and the stand-in fields, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def groups():
    """One reference-encoded group per nbits (48, the archive default, and
    64, whose magnitudes set bit 63), as both packages' LevelBitplanes."""
    rng = np.random.default_rng(7)
    c = rng.standard_normal(1000) * np.exp(rng.uniform(-8, 4, 1000))
    c[::17] = 0.0
    out = {}
    for nbits in (48, 64):
        j = jenc.encode_level(c, nbits=nbits)
        t = tenc.LevelBitplanes(count=j.count, exponent=j.exponent,
                                nbits=j.nbits, planes=list(j.planes),
                                plane_raw_bits=j.plane_raw_bits,
                                signs=j.signs)
        out[nbits] = (j, t)
    return out


@pytest.mark.parametrize("nbits", (48, 64))
@pytest.mark.parametrize("k", (0, 1, 31, 32, 33, 48, 64))
def test_decode_magnitudes_and_values_bit_equal_to_reference(groups, nbits,
                                                             k):
    j, t = groups[nbits]
    jmag = jenc.decode_magnitudes(j, k)
    tmag = tenc.decode_magnitudes(t, k, device=CPU)
    assert tmag.dtype == torch.int64 and tmag.shape == (j.count,)
    np.testing.assert_array_equal(tmag.numpy().view(np.uint64), jmag)
    np.testing.assert_array_equal(_bits(tenc.decode_values(t, tmag)),
                                  _bits(jenc.decode_values(j, jmag)))
    # incrementally: planes [0, start) then [start, k) from that state
    for start in sorted({0, k // 3, k - 1, min(k, nbits)}):
        if start < 0:
            continue
        js = jenc.decode_magnitudes(j, start)
        ts = tenc.decode_magnitudes(t, start, device=CPU)
        jm = jenc.decode_magnitudes(j, k, state=js.copy(), start=start)
        tm = tenc.decode_magnitudes(t, k, state=ts, start=start)
        np.testing.assert_array_equal(tm.numpy().view(np.uint64), jm)
    # start past k returns the state (or zeros) unchanged
    state = tenc.decode_magnitudes(t, 5, device=CPU)
    assert tenc.decode_magnitudes(t, k, state=state, start=k) is state
    np.testing.assert_array_equal(
        tenc.decode_magnitudes(t, k, start=k, device=CPU).numpy(),
        jenc.decode_magnitudes(j, k, start=k).view(np.int64))


def test_decode_magnitudes_all_zero_group():
    j = jenc.encode_level(np.zeros(77))
    t = tenc.encode_level(torch.zeros(77, dtype=torch.float64))
    assert t.exponent is None and j.exponent is None
    for k, state in ((0, None), (48, None), (48, torch.ones(77, dtype=torch.int64))):
        tm = tenc.decode_magnitudes(t, k, state=state, device=CPU)
        jm = jenc.decode_magnitudes(j, k)
        np.testing.assert_array_equal(tm.numpy().view(np.uint64), jm)
        np.testing.assert_array_equal(_bits(tenc.decode_values(t, tm)),
                                      _bits(jenc.decode_values(j, jm)))


def test_decode_magnitudes_wants_cuda_without_a_state(groups, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.decode_magnitudes(groups[48][1], 4)


@pytest.mark.parametrize("fn,shape", (
    ("nyx_like_fields", None), ("nyx_like_fields", (17, 33, 33)),
    ("s3d_like_fields", None), ("s3d_like_fields", (17, 33, 33))))
def test_stand_in_fields_bit_equal_to_reference(fn, shape):
    kw = {} if shape is None else {"shape": shape, "seed": 42}
    want = getattr(jsyn, fn)(**kw)
    got = getattr(tsyn, fn)(**kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        np.testing.assert_array_equal(got[k].view(np.int64),
                                      want[k].view(np.int64))
    if fn == "s3d_like_fields":           # aliases by species name
        assert got["H2"] is got["x0"] and got["H2O2"] is got["x7"]


# ---------------------------------------------------------------------------
# unverified opens (mirrors of tests/test_store.py, tests/test_http_store.py)
# ---------------------------------------------------------------------------


def test_unverified_open_fetches_a_corrupt_segment(hb, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(hb, path)
    with open_archive(path, device=CPU) as sa:
        key, entry = max(sa.fetcher.index.items(), key=lambda kv: kv[1].size)
    with open(path, "r+b") as fh:
        fh.seek(entry.offset + entry.size // 2)
        b = fh.read(1)
        fh.seek(entry.offset + entry.size // 2)
        fh.write(bytes([b[0] ^ 0x40]))
    with open_archive(path, device=CPU) as sa:
        with pytest.raises(ChecksumError, match="crc32c"):
            sa.fetcher.fetch(key)
    # verify=False trusts the transport: the fetch itself must not raise
    with open_archive(path, OpenOptions.unverified(), device=CPU) as sa:
        sa.fetcher.fetch(key)


def test_unverified_fetcher_never_populates_shared_cache(hb, tmp_path):
    path = str(tmp_path / "a.prs")
    save_archive(hb, path)
    cache = SegmentCache()
    with open_archive(path, OpenOptions(verify=False, cache=cache),
                      device=CPU) as sa:
        sa.open().reconstruct("Vx", 1e-4)
        assert cache.stats.insertions == 0
        assert len(cache) == 0
    with open_archive(path, OpenOptions.unverified().with_(cache=cache),
                      device=CPU) as sa:
        sa.open().reconstruct("Vx", 1e-4)
        assert cache.stats.insertions == 0
    with open_archive(path, OpenOptions(verify=True, cache=cache),
                      device=CPU) as sa:
        sa.open().reconstruct("Vx", 1e-4)
        assert cache.stats.insertions > 0
