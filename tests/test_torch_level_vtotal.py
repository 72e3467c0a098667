"""The port's hierarchical-surplus and fused-Vtotal entry points
(``repro_torch.kernels.ops.level_surplus`` / ``vtotal_with_bound``, their
plain versions on the CPU) against the JAX package's Pallas kernels in
interpret mode, on the same numpy-seeded inputs.

Tolerances: the surplus is bit-equal in both dtypes (``0.5 * s`` is exact,
so every order of evaluation rounds alike).  The Vtotal bound is held to
rtol 1e-14 in float64 and 1e-6 in float32: the reference's interpret mode
runs the kernel body as one XLA-compiled CPU graph, which may round a step
differently from the port's one-rounding-per-operation order; each float64
case records whether it came out bit-equal anyway.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro._x64  # noqa: E402,F401  (float64 in the reference)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import ge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.hier_level import hier_level_surplus  # noqa: E402
from repro_torch.kernels.qoi_vtotal import qoi_vtotal  # noqa: E402
from repro_torch.transform.hierarchical import decompose_hb, level_map  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- hier level --
@pytest.mark.parametrize("batch,m", [(8, 128), (16, 256), (8, 512), (5, 64),
                                     (5, 1), (1, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_level_surplus_bit_equal_to_jax(batch, m, dtype):
    nd, td = DTYPES[dtype]
    rng = np.random.default_rng(batch + m)
    even = rng.standard_normal((batch, m + 1)).astype(nd)
    odd = rng.standard_normal((batch, m)).astype(nd)
    want = np.asarray(jops.level_surplus(jnp.asarray(even), jnp.asarray(odd)))
    launches = hier_level_surplus.launches
    got = ops.level_surplus(_t(even), _t(odd))
    assert hier_level_surplus.launches == launches   # CPU: the plain version
    assert got.dtype == td and tuple(got.shape) == (batch, m)
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  want.view(np.uint8))


def test_hier_level_agrees_with_transform():
    """The surplus of the deinterleaved finest level equals what the port's
    decompose_hb computes at level 0 of a 1-D grid."""
    rng = np.random.default_rng(11)
    n = 257
    x = rng.standard_normal(n)
    c = decompose_hb(_t(x), 1).numpy()
    lm = level_map((n,), 1)
    out = ops.level_surplus(_t(x[0::2][None, :]), _t(x[1::2][None, :]))[0]
    np.testing.assert_allclose(out.numpy(), c[lm == 0], rtol=1e-12)


def test_level_surplus_refuses_bad_inputs():
    e = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.level_surplus(e, torch.zeros((2, 5), dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.level_surplus(e, torch.zeros((2, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.level_surplus(torch.zeros((2, 1)), torch.zeros((2, 0)))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.level_surplus(e.to("meta"),
                          torch.zeros((2, 4), dtype=torch.float64,
                                      device="meta"))


# ------------------------------------------------------------- qoi vtotal --
def _velocities(rng, n, nd):
    """Gaussian velocities with exact zeros (bound +inf) and points small
    enough that s < eps_s (negative radicand)."""
    v = [rng.standard_normal(n) * s for s in (100.0, 80.0, 50.0)]
    for a in v:
        a[: n // 16] *= 1e-4
        a[n // 16: n // 16 + max(1, n // 64)] = 0.0
    return [a.astype(nd) for a in v]


@pytest.mark.parametrize("n", [1024, 4096, 1, 127, 1025])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vtotal_with_bound_matches_jax(n, dtype, record_property):
    nd, td = DTYPES[dtype]
    rng = np.random.default_rng(n)
    vx, vy, vz = _velocities(rng, n, nd)
    eps = [0.5, 0.3, 0.1]
    jv, jb = (np.asarray(a) for a in jops.vtotal_with_bound(
        jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(vz),
        jnp.asarray(np.asarray(eps, dtype=nd))))
    launches = qoi_vtotal.launches
    tv, tb = ops.vtotal_with_bound(_t(vx), _t(vy), _t(vz), eps)
    assert qoi_vtotal.launches == launches
    assert tv.dtype == td and tb.dtype == td
    tv, tb = tv.numpy(), tb.numpy()
    np.testing.assert_array_equal(np.isinf(tb), np.isinf(jb))
    assert np.isinf(tb).any()                     # the zero-velocity points
    rtol = 1e-14 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=0)
    np.testing.assert_allclose(tb, jb, rtol=rtol, atol=0)
    record_property("bit_equal", bool(np.array_equal(tv, jv)
                                      and np.array_equal(tb, jb)))


def test_vtotal_eps_is_rounded_to_the_dtype():
    """float32 inputs see float32 eps, as the reference casts its eps array
    to the inputs' dtype."""
    rng = np.random.default_rng(5)
    v = [_t(rng.standard_normal(64).astype(np.float32)) for _ in range(3)]
    eps = [0.1, 1.0 / 3.0, 0.7]
    got = ops.vtotal_with_bound(*v, eps)
    rounded = [float(np.float32(e)) for e in eps]
    want = ops.vtotal_with_bound(*v, rounded)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_vtotal_propagates_nan_like_jnp_maximum():
    vx = torch.tensor([float("nan"), 3.0], dtype=torch.float64)
    vy = torch.tensor([1.0, 4.0], dtype=torch.float64)
    val, bound = ops.vtotal_with_bound(vx, vy, torch.zeros(2,
                                                           dtype=torch.float64),
                                       [0.1, 0.1, 0.1])
    assert torch.isnan(val[0]) and torch.isinf(bound[0])
    assert val[1] == 5.0 and torch.isfinite(bound[1])


def test_qoi_vtotal_matches_expression():
    """The fused kernel == the composable AST estimator (core.qoi) for
    Vtotal."""
    rng = np.random.default_rng(17)
    n = 2048
    fields = {"Vx": rng.standard_normal(n) * 10,
              "Vy": rng.standard_normal(n) * 10,
              "Vz": rng.standard_normal(n) * 10}
    eps = {"Vx": 0.02, "Vy": 0.05, "Vz": 0.01}
    ev, eb = ge.v_total().eval(
        {k: _t(v) for k, v in fields.items()},
        {k: torch.full((n,), e, dtype=torch.float64) for k, e in eps.items()})
    val, bound = ops.vtotal_with_bound(
        _t(fields["Vx"]), _t(fields["Vy"]), _t(fields["Vz"]),
        [eps["Vx"], eps["Vy"], eps["Vz"]])
    np.testing.assert_allclose(val.numpy(), ev.numpy(), rtol=1e-12)
    np.testing.assert_allclose(bound.numpy(), eb.numpy(), rtol=1e-12)


def test_qoi_vtotal_bound_validity():
    """The bound is a true upper bound under admissible perturbations."""
    rng = np.random.default_rng(23)
    n = 1024
    vx, vy, vz = (rng.standard_normal(n) for _ in range(3))
    eps = np.array([0.05, 0.02, 0.04])
    val, bound = (a.numpy() for a in ops.vtotal_with_bound(
        _t(vx), _t(vy), _t(vz), eps.tolist()))
    for _ in range(5):
        px = vx + rng.uniform(-1, 1, n) * eps[0]
        py = vy + rng.uniform(-1, 1, n) * eps[1]
        pz = vz + rng.uniform(-1, 1, n) * eps[2]
        truth = np.sqrt(px ** 2 + py ** 2 + pz ** 2)
        finite = np.isfinite(bound)
        assert np.all(np.abs(truth - val)[finite] <=
                      bound[finite] * (1 + 1e-9) + 1e-12)


def test_vtotal_refuses_bad_inputs():
    v = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(TypeError, match="host floats"):
        ops.vtotal_with_bound(v, v, v, torch.tensor([0.1, 0.1, 0.1]))
    with pytest.raises(ValueError):
        ops.vtotal_with_bound(v, v, v, [0.1, 0.1])
    with pytest.raises(TypeError):
        ops.vtotal_with_bound(v, v, v.float(), [0.1, 0.1, 0.1])
    with pytest.raises(ValueError):
        ops.vtotal_with_bound(v, v, torch.zeros(4, dtype=torch.float64),
                              [0.1, 0.1, 0.1])
    m = v.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.vtotal_with_bound(m, m, m, [0.1, 0.1, 0.1])
