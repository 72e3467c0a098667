"""The ip and ob representations of the port against the JAX package, on the
CPU, on 1-D, 2-D and 3-D fields.

* ob's transform (``decompose_ob``, ``recompose_ob``, ``project_detail``,
  ``_thomas_axis``) and ip's truncated contribution
  (``scatter_recompose_ip_from``) bit for bit against the reference's
  ``jax.jit`` functions;
* the ip encoder (groups, ``pred_planes``) and whole archives, single-file
  and sharded, byte-identical; each package reading the other's containers;
* retrieval on ip and ob archives: per-iteration eps, bytes, est_errors and
  reconstructions identical;
* ``reconstruct_at_resolution`` on the cases of ``tests/test_resolution.py``
  for hb and ip, against the reference.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.core import ge as jge  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data.synthetic import ge_like_fields, smooth_field  # noqa: E402
from repro.store.container import open_archive as jax_open  # noqa: E402
from repro.store.container import save_archive as jax_save  # noqa: E402
from repro.store.container import save_sharded_archive as jax_save_sharded  # noqa: E402
from repro.transform import hierarchical as jhier  # noqa: E402
from repro.transform import orthogonal as jortho  # noqa: E402
from repro_torch.core import ge as tge  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.kernels.thomas import thomas_solve  # noqa: E402
from repro_torch.store import open_archive, save_archive, \
    save_sharded_archive  # noqa: E402
from repro_torch.transform import hierarchical as thier  # noqa: E402
from repro_torch.transform import orthogonal as tortho  # noqa: E402

CPU = "cpu"
GRIDS = ((257,), (33, 17), (9, 17, 5), (65, 3), (3,))
FIELD_SHAPES = ((257,), (33, 17), (9, 10, 11), (65, 3))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _field(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) * 10.0


@pytest.mark.parametrize("shape", GRIDS, ids=str)
def test_ob_transform_matches_jit(shape):
    x = _field(shape)
    levels = jhier.grid_levels(shape)
    jd = np.asarray(jortho.decompose_ob(jnp.asarray(x), levels))
    td = tortho.decompose_ob(torch.from_numpy(x), levels)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    jr = np.asarray(jortho.recompose_ob(jnp.asarray(jd), levels))
    tr = tortho.recompose_ob(torch.from_numpy(jd.copy()), levels)
    np.testing.assert_array_equal(_bits(tr), _bits(jr))
    jp = np.asarray(jax.jit(jortho.project_detail)(jnp.asarray(x)))
    np.testing.assert_array_equal(
        _bits(tortho.project_detail(torch.from_numpy(x))), _bits(jp))


@pytest.mark.parametrize("shape", ((1,), (2,), (5,), (129,), (9, 17),
                                   (5, 3, 9)), ids=str)
def test_thomas_axis_matches_jit(shape):
    b = _field(shape, seed=3)
    for ax in range(len(shape)):
        want = np.asarray(jax.jit(jortho._thomas_axis,
                                  static_argnums=1)(jnp.asarray(b), ax))
        got = tortho._thomas_axis(torch.from_numpy(b), ax)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(thomas_solve(
            torch.from_numpy(b), ax)), _bits(want))


@pytest.mark.parametrize("shape", ((257,), (33, 17), (9, 9, 17)), ids=str)
def test_scatter_recompose_ip_from_matches_jit(shape):
    rng = np.random.default_rng(5)
    levels = jhier.grid_levels(shape)
    lmap = jhier.level_map(shape, levels).ravel()
    for l in (0, levels // 2, levels):
        idx = np.flatnonzero(lmap == l)
        for q in (0.0, 2.0 ** -3, 2.0 ** -20):
            vals = np.round(rng.standard_normal(idx.size) * 2 ** 12) * 2.0 ** -14
            vals[:3] = -0.0
            want = np.asarray(jhier.scatter_recompose_ip_from(
                jnp.asarray(idx), jnp.asarray(vals), shape, levels,
                min(l, levels - 1), q))
            got = thier.scatter_recompose_ip_from(
                torch.from_numpy(idx), torch.from_numpy(vals), shape, levels,
                min(l, levels - 1), q)
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _fields(shape):
    return {"S": smooth_field(shape, seed=5, lo=-3.0, hi=9.0),
            "R": _field(shape, seed=1)}


@pytest.mark.parametrize("shape", FIELD_SHAPES, ids=str)
def test_ip_encoder_matches_reference(shape):
    fields = _fields(shape)
    ja = jax_refactor(fields, method="ip")
    ta = refactor_variables(fields, method="ip", device=CPU)
    for name, jv in ja.variables.items():
        tv = ta.variables[name]
        assert tv.levels == jv.levels
        for ji, ti in zip(jv.group_indices, tv.group_indices):
            np.testing.assert_array_equal(ti, ji)
        for jg, tg in zip(jv.groups, tv.groups):
            assert (tg.count, tg.exponent, tg.nbits, tg.pred_planes) == \
                (jg.count, jg.exponent, jg.nbits, jg.pred_planes)
            assert tg.planes == jg.planes and tg.signs == jg.signs


def _read_dir(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("method", ("ip", "ob"))
@pytest.mark.parametrize("shape", FIELD_SHAPES, ids=str)
def test_archives_byte_identical(tmp_path, shape, method):
    fields = _fields(shape)
    ja = jax_refactor(fields, method=method)
    ta = refactor_variables(fields, method=method, device=CPU)
    jax_save(ja, str(tmp_path / "j.prs"))
    save_archive(ta, str(tmp_path / "t.prs"))
    assert (tmp_path / "j.prs").read_bytes() == \
        (tmp_path / "t.prs").read_bytes()
    for shard_by in ("variable", "group"):
        jd, td = tmp_path / f"j_{shard_by}", tmp_path / f"t_{shard_by}"
        jax_save_sharded(ja, str(jd), shard_by=shard_by)
        save_sharded_archive(ta, str(td), shard_by=shard_by)
        assert _read_dir(jd) == _read_dir(td)


@pytest.mark.parametrize("method", ("ip", "ob"))
def test_each_package_reads_the_others_containers(tmp_path, method):
    fields = _fields((33, 17))
    ja = jax_refactor(fields, method=method)
    ta = refactor_variables(fields, method=method, device=CPU)
    jax_save_sharded(ja, str(tmp_path / "j"), shard_by="variable")
    save_archive(ta, str(tmp_path / "t.prs"))
    with open_archive(str(tmp_path / "j"), device=CPU) as port_reads_jax, \
            jax_open(str(tmp_path / "t.prs")) as jax_reads_port:
        ts, js = port_reads_jax.open(), jax_reads_port.open()
        for eps in (1e-1, 1e-4, 1e-9, 0.0):
            for v in fields:
                a, ab = ts.reconstruct(v, eps * ja.ranges[v])
                b, bb = js.reconstruct(v, eps * ja.ranges[v])
                np.testing.assert_array_equal(_bits(a), _bits(b))
                assert ab == bb
        assert ts.bytes_retrieved == js.bytes_retrieved


@pytest.mark.parametrize("tight", (False, True), ids=("loose", "tight"))
@pytest.mark.parametrize("method", ("ip", "ob"))
@pytest.mark.parametrize("shape", ((4096,), (17, 33)), ids=str)
def test_retrieval_matches_jax(shape, method, tight):
    n = int(np.prod(shape))
    fields = {k: np.asarray(v).reshape(shape)
              for k, v in ge_like_fields(n=n, seed=0).items()}
    rounds = ((("VTOT", "v_total", 1e-4), ("Mach", "mach", 1e-4)),
              (("T", "temperature", 1e-6), ("PT", "total_pressure", 1e-9)))
    js = jax_refactor(fields, method=method).open()
    ts = refactor_variables(fields, method=method, device=CPU).open()

    def expr(pkg, f):
        return getattr(pkg, f)(tight=tight) if f != "temperature" \
            else pkg.temperature()

    for reqs in rounds:
        jr = jax_retrieve(js, [JaxRequest(q, expr(jge, f), tau)
                               for q, f, tau in reqs])
        tr = retrieve_qoi_controlled(ts, [QoIRequest(q, expr(tge, f), tau)
                                          for q, f, tau in reqs])
        assert [(i.eps, i.bytes_retrieved, i.est_errors)
                for i in tr.iterations] == \
            [(i.eps, i.bytes_retrieved, i.est_errors) for i in jr.iterations]
        assert tr.est_errors == jr.est_errors
        assert tr.converged and jr.converged
        for k, v in jr.values.items():
            np.testing.assert_array_equal(_bits(tr.values[k]), _bits(v))


@pytest.mark.parametrize("method", ("hb", "ip"))
@pytest.mark.parametrize("coarsen", (1, 2))
@pytest.mark.parametrize("shape", ((257,), (33, 33)), ids=str)
def test_resolution_progression_matches_reference(shape, coarsen, method):
    data = {"F": smooth_field(shape, 5, lo=-3.0, hi=9.0)}
    ja = jax_refactor(data, method=method, mask_zero_velocity=False)
    ta = refactor_variables(data, method=method, mask_zero_velocity=False,
                            device=CPU)
    eps = 1e-6 * ta.ranges["F"]
    js, ts = ja.open(), ta.open()
    want, want_bound = js.reconstruct_at_resolution("F", coarsen, eps)
    coarse, achieved = ts.reconstruct_at_resolution("F", coarsen, eps)
    np.testing.assert_array_equal(_bits(coarse), _bits(want))
    assert achieved == want_bound
    assert ts.bytes_retrieved == js.bytes_retrieved
    truth = data["F"][tuple(slice(None, None, 1 << coarsen) for _ in shape)]
    assert tuple(coarse.shape) == truth.shape
    assert np.abs(coarse.numpy() - truth).max() <= achieved * (1 + 1e-12)
    assert achieved <= eps * (1 + 1e-12)


@pytest.mark.parametrize("method", ("hb", "ip"))
def test_resolution_skips_fine_bytes(method):
    data = {"F": smooth_field((1025,), 7, lo=0.0, hi=1.0)}
    ta = refactor_variables(data, method=method, mask_zero_velocity=False,
                            device=CPU)
    s_coarse, s_full = ta.open(), ta.open()
    s_coarse.reconstruct_at_resolution("F", 2, 1e-8)
    s_full.reconstruct("F", 1e-8)
    assert s_coarse.bytes_retrieved < s_full.bytes_retrieved


def test_resolution_refuses_ob():
    data = {"F": smooth_field((129,), 1)}
    ta = refactor_variables(data, method="ob", mask_zero_velocity=False,
                            device=CPU)
    with pytest.raises(ValueError, match="method='hb'"):
        ta.open().reconstruct_at_resolution("F", 1, 1e-4)
