"""The port's refactor, reader and QoI-controlled retrieval against the JAX
package on the same GE-like fields.

Exact where the reference math is exact: archive bytes, decoded values,
reconstructions, and the retrieval's decisions (per-iteration eps and
bytes).  The QoI values and bounds are held bit for bit to the reference
as its retrieval computes them, under ``jax.jit`` (the port places a fused
multiply-add wherever XLA's CPU backend does, ROADMAP C3) — except the
logarithm, whose XLA and torch implementations are not correctly rounded
and differ in the last place (rtol 1e-14); bit-equal est_errors on
retrieval are ``tests/test_torch_fma.py``'s.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.bitplane import encoder as jenc  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.core import ge as jge  # noqa: E402
from repro.core import qoi as jqoi  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data.synthetic import ge_like_fields as jax_fields  # noqa: E402
from repro.options import SessionOptions as JaxSessionOptions  # noqa: E402
from repro_torch.bitplane import encoder as tenc  # noqa: E402
from repro_torch.convert import archive_from_arrays, archive_to_arrays  # noqa: E402
from repro_torch.core import estimators as test_  # noqa: E402
from repro_torch.core import ge as tge  # noqa: E402
from repro_torch.core import qoi as tqoi  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.options import SessionOptions  # noqa: E402

N = 4096
CPU = torch.device("cpu")
# (requests) per round of one session, as examples/quickstart.py serves them
ROUNDS = ((("VTOT", "v_total", 1e-4), ("Mach", "mach", 1e-4)),
          (("VTOT", "v_total", 1e-6),))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _jax_archive_arrays(a):
    """The plain layout of ``repro_torch.convert`` from a JAX archive
    (duck-typed: only attributes are read)."""
    return {
        "method": a.method,
        "shapes": dict(a.shapes), "ranges": dict(a.ranges),
        "masks": {k: {"mask": m.mask, "values": m.values}
                  for k, m in a.masks.items()},
        "variables": {
            name: {"orig_shape": v.orig_shape,
                   "padded_shape": v.padded_shape, "levels": v.levels,
                   "group_indices": list(v.group_indices),
                   "groups": [{"count": g.count, "exponent": g.exponent,
                               "nbits": g.nbits, "planes": g.planes,
                               "signs": g.signs} for g in v.groups]}
            for name, v in a.variables.items()},
    }


@pytest.fixture(scope="module")
def fields():
    return ge_like_fields(n=N, seed=0)


@pytest.fixture(scope="module")
def jax_archive(fields):
    return jax_refactor(fields, method="hb")


@pytest.fixture(scope="module")
def port_archive(fields):
    return refactor_variables(fields, method="hb", device="cpu")


@pytest.fixture(scope="module")
def jax_results(jax_archive):
    session = jax_archive.open()
    return [jax_retrieve(session, [JaxRequest(q, getattr(jge, f)(), tau)
                                   for q, f, tau in reqs])
            for reqs in ROUNDS]


def _port_results(archive):
    session = archive.open()
    return [retrieve_qoi_controlled(session,
                                    [QoIRequest(q, getattr(tge, f)(), tau)
                                     for q, f, tau in reqs])
            for reqs in ROUNDS]


def test_synthetic_fields_are_the_reference_fields(fields):
    want = jax_fields(n=N, seed=0)
    assert list(fields) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(fields[k]), _bits(want[k]))


def test_archive_bytes_identical(jax_archive, port_archive):
    assert port_archive.total_nbytes == jax_archive.total_nbytes
    assert port_archive.ranges == jax_archive.ranges
    assert port_archive.shapes == jax_archive.shapes
    for name, m in jax_archive.masks.items():
        assert np.array_equal(port_archive.masks[name].mask, m.mask)
        assert np.array_equal(port_archive.masks[name].values, m.values)
    for name, jv in jax_archive.variables.items():
        tv = port_archive.variables[name]
        assert (tv.orig_shape, tv.padded_shape, tv.levels) == \
            (jv.orig_shape, jv.padded_shape, jv.levels)
        for ji, ti in zip(jv.group_indices, tv.group_indices):
            np.testing.assert_array_equal(ti, ji)
        assert len(tv.groups) == len(jv.groups)
        for jg, tg in zip(jv.groups, tv.groups):
            assert (tg.count, tg.exponent, tg.nbits) == \
                (jg.count, jg.exponent, jg.nbits)
            assert tg.planes == jg.planes
            assert tg.signs == jg.signs


@pytest.mark.parametrize("k", (0, 1, 47, 48))
def test_decode_prefix_bit_identical(jax_archive, port_archive, k):
    for name in ("Vx", "P"):
        jv, tv = jax_archive.variables[name], port_archive.variables[name]
        for l in (0, jv.levels // 2, jv.levels):
            want = jenc.decode_prefix(jv.groups[l], k)
            got = tenc.decode_prefix(tv.groups[l], k, CPU)
            np.testing.assert_array_equal(_bits(got), _bits(want))
            assert tenc.plane_bound(tv.groups[l], k) == \
                jenc.plane_bound(jv.groups[l], k)


@pytest.mark.parametrize("start,stop", ((0, 1), (0, 30), (30, 48), (5, 5)))
def test_accumulate_and_values_from_planes_match(jax_archive, port_archive,
                                                 start, stop):
    jg = jax_archive.variables["Vy"].groups[0]
    tg = port_archive.variables["Vy"].groups[0]
    jmag = jenc.accumulate_planes(jg.count, jg.nbits, jg.planes[start:stop],
                                  start)
    tmag = tenc.accumulate_planes(tg.count, tg.nbits, tg.planes[start:stop],
                                  start, device=CPU)
    np.testing.assert_array_equal(tmag.numpy(), jmag.astype(np.int64))
    np.testing.assert_array_equal(
        _bits(tenc.values_from_planes(tg.count, tg.exponent, tg.nbits, tmag,
                                      tg.signs)),
        _bits(jenc.values_from_planes(jg.count, jg.exponent, jg.nbits, jmag,
                                      jg.signs)))


def _check_against_jax(results, jax_results, fields):
    exprs = {"VTOT": tge.v_total(), "Mach": tge.mach()}
    truth = {q: e.value(fields) for q, e in exprs.items()}
    for got, want in zip(results, jax_results):
        assert got.converged and want.converged
        assert len(got.iterations) == len(want.iterations)
        for gi, wi in zip(got.iterations, want.iterations):
            assert gi.eps == wi.eps
            assert gi.bytes_retrieved == wi.bytes_retrieved
            for q in wi.est_errors:
                assert math.isclose(gi.est_errors[q], wi.est_errors[q],
                                    rel_tol=1e-14)
                assert math.isclose(gi.tau_abs[q], wi.tau_abs[q],
                                    rel_tol=1e-14)
        assert got.bytes_retrieved == want.bytes_retrieved
        assert got.bitrate == want.bitrate
        assert got.achieved_eb == want.achieved_eb
        for k in want.values:
            np.testing.assert_array_equal(_bits(got.values[k]),
                                          _bits(want.values[k]))
        for q, est in got.est_errors.items():
            assert math.isclose(est, want.est_errors[q], rel_tol=1e-14)
            true = float((truth[q] - exprs[q].value(got.values)).abs().max())
            assert true <= est <= got.tau_abs[q]


def test_retrieval_matches_jax(port_archive, jax_results, fields):
    _check_against_jax(_port_results(port_archive), jax_results, fields)


def test_retrieval_from_converted_jax_archive(jax_archive, jax_results,
                                              fields):
    archive = archive_from_arrays(_jax_archive_arrays(jax_archive),
                                  device="cpu")
    _check_against_jax(_port_results(archive), jax_results, fields)


def test_convert_round_trip(port_archive):
    d = archive_to_arrays(port_archive)
    back = archive_to_arrays(archive_from_arrays(d, device="cpu"))
    assert back["method"] == d["method"] and back["ranges"] == d["ranges"]
    assert back["shapes"] == d["shapes"]
    for name, v in d["variables"].items():
        w = back["variables"][name]
        assert w["groups"] == v["groups"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(w["group_indices"], v["group_indices"]))
    for name, m in d["masks"].items():
        assert np.array_equal(back["masks"][name]["mask"], m["mask"])
        assert np.array_equal(back["masks"][name]["values"], m["values"])


@pytest.mark.parametrize("fields_budget", (0, 3))
def test_contribution_budget_matches_jax(jax_archive, port_archive,
                                         fields_budget):
    """Bounded readers reconstruct bit-identically to unbounded ones, and
    spill/recompute exactly as the reference does."""
    name = "Vz"
    field_bytes = int(np.prod(port_archive.variables[name].padded_shape)) * 8
    budget = fields_budget * field_bytes
    js = jax_archive.open(JaxSessionOptions.memory_bounded(budget))
    ts = port_archive.open(SessionOptions.memory_bounded(budget))
    free = port_archive.open()
    rng = port_archive.ranges[name]
    for rel in (1e-2, 1e-4, 1e-4, 1e-7, 1e-3):
        jd, jb = js.reconstruct(name, rel * rng)
        td, tb = ts.reconstruct(name, rel * rng)
        fd, _ = free.reconstruct(name, rel * rng)
        assert tb == jb
        np.testing.assert_array_equal(_bits(td), _bits(jd))
        np.testing.assert_array_equal(_bits(fd), _bits(td))
    assert ts.contrib_stats().contrib_snapshot() == \
        js.contrib_stats().contrib_snapshot()
    reader = ts.readers[name]
    assert reader.contrib_resident_levels == list(range(fields_budget))


def test_any_fetch_schedule_reconstructs_bit_identically(port_archive):
    name = "P"
    rng = port_archive.ranges[name]
    ladder = port_archive.open()
    for rel in (1e-1, 1e-3, 1e-5, 1e-9):
        ladder.reconstruct(name, rel * rng)
    direct = port_archive.open()
    a, ab = ladder.reconstruct(name, 1e-9 * rng)
    b, bb = direct.reconstruct(name, 1e-9 * rng)
    assert ab == bb
    assert ladder.readers[name].state_signature() == \
        direct.readers[name].state_signature()
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _node_trees(q):
    a, b = q.Var("a"), q.Var("b")
    return {
        "var": a,
        "const": q.Sum([a, q.Const(2.5)], coeffs=[1.0, 3.0]),
        "sum": q.Sum([a, b], coeffs=[1.5, -0.25], const=0.75),
        "prod": q.Prod(a, b),
        "quot": q.Quot(a, b),
        "intpow2": q.IntPow(a, 2),
        "intpow3": q.IntPow(b, 3),
        "intpow5": q.IntPow(a, 5),
        "sqrt": q.Sqrt(q.Sum([q.IntPow(a, 2), b])),
        "sqrt_tight": q.Sqrt(q.Sum([q.IntPow(a, 2), b]), tight=True),
        "radical": q.Radical(b, c=0.5),
        "log": q.Log(b),
        "frac_pow": q.frac_pow(b, 3.5),
    }


def _node_inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 3.0
    b = np.abs(rng.standard_normal(n)) + 0.05
    b[:8] = 0.0                                   # guard edges
    ea = np.abs(rng.standard_normal(n)) * 1e-3
    eb = np.abs(rng.standard_normal(n)) * 1e-3
    ea[8:12] = np.inf                             # +inf child bounds
    eb[12:16] = 0.0                               # exact points
    eb[16:20] = 10.0                              # guard violations
    return {"a": a, "b": b}, {"a": ea, "b": eb}


def _jit_eval(expr, vals, ebs):
    """(value, bound) as the reference's retrieval computes them."""
    return jax.jit(lambda v, e: expr.eval(v, e))(vals, ebs)


@pytest.mark.parametrize("node", sorted(_node_trees(tqoi)))
def test_expression_nodes_match_jax(node):
    for seed in (0, 1, 2):
        vals, ebs = _node_inputs(seed)
        jv, jb = _jit_eval(_node_trees(jqoi)[node], vals, ebs)
        tv, tb = _node_trees(tqoi)[node].eval(
            {k: torch.from_numpy(v) for k, v in vals.items()},
            {k: torch.from_numpy(v) for k, v in ebs.items()})
        if node == "log":
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-14)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                       rtol=1e-14)
        else:
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
            np.testing.assert_array_equal(_bits(tb), _bits(jb))


def test_ge_qois_match_jax(fields):
    rng = np.random.default_rng(3)
    ebs = {k: np.abs(rng.standard_normal(N)) * 1e-4 * (np.max(v) - np.min(v))
           for k, v in fields.items()}
    jq, tq = jge.all_qois(), tge.all_qois()
    for name in jq:
        jv, jb = _jit_eval(jq[name], fields, ebs)
        tv, tb = tq[name].eval({k: torch.from_numpy(v)
                                for k, v in fields.items()},
                               {k: torch.from_numpy(v)
                                for k, v in ebs.items()})
        np.testing.assert_array_equal(_bits(tv), _bits(jv))
        np.testing.assert_array_equal(_bits(tb), _bits(jb))


@pytest.mark.parametrize("fn", ("bound_intpow", "bound_sqrt", "bound_radical",
                                "bound_log", "bound_prod", "bound_quot",
                                "bound_sum"))
def test_estimators_match_jax(fn):
    for seed in (0, 1):
        vals, ebs = _node_inputs(seed)
        x, y, ex, ey = vals["a"], vals["b"], ebs["a"], ebs["b"]
        args = {"bound_intpow": [(x, ex, n) for n in (1, 2, 3, 4)],
                "bound_sqrt": [(y, ey, False), (y, ey, True)],
                "bound_radical": [(x, ex, 0.5), (y, ey, -0.2)],
                "bound_log": [(y, ey)],
                "bound_prod": [(x, ex, y, ey)],
                "bound_quot": [(x, ex, y, ey)],
                "bound_sum": [((1.5, -2.0), (ex, ey))]}[fn]
        for case in args:
            want = np.asarray(getattr(jest, fn)(*case))
            conv = tuple(torch.from_numpy(c) if isinstance(c, np.ndarray)
                         else tuple(torch.from_numpy(e) for e in c)
                         if isinstance(c, tuple) and fn == "bound_sum"
                         and isinstance(c[0], np.ndarray) else c
                         for c in case)
            got = getattr(test_, fn)(*conv).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-14)
