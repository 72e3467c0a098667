"""The Thomas solve's factor table and quotient (``kernels/thomas.py``,
``csrc/thomas.cu``) on the CPU, against the plain version and the JAX
package.

* the kernel's factor table, expanded, equals the plain factors
  (``ref.thomas_factors_ref``) bit for bit, and its fixed point is detected;
* the kernel's quotient — Markstein's sequence from a cached reciprocal
  inside its guard, the division outside — emulated exactly
  (``ref.thomas_quotient_ref``), equals float64 division bit for bit, signed
  zeros included, for 10^5 seeded x per table denominator and on the edge
  set;
* a line-by-line model of the kernel's sweeps (table rows and guarded
  quotient) equals the plain solve on lines with edge values;
* ob's ``_thomas_axis`` and ``project_detail`` equal ``jax.jit`` of the
  reference's on lines longer than the table along every axis.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.transform import orthogonal as jortho  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import thomas  # noqa: E402
from repro_torch.transform import orthogonal as tortho  # noqa: E402

F64 = torch.float64
TINY = 5e-324
LO, HI = ref.THOMAS_QUOTIENT_RANGE
# every denominator any table holds: lines of 1 .. K+3 nodes cover them all
DENOMS = sorted({row[0] for n in range(1, thomas.fixed_index() + 4)
                 for row in thomas.factor_table(n)[0]})
EDGES = (0.0, TINY, 2.0 ** -1022, math.ulp(0.0) * 3, LO, math.nextafter(LO, 0),
         math.nextafter(LO, 1), 2.0 ** -968, HI, math.nextafter(HI, 0),
         math.nextafter(HI, math.inf), 2.0 ** 1023, 1e307,
         math.nextafter(math.inf, 0), math.inf, 1.0, 3.0)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, any NaN matching any NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and \
        torch.equal(a[~nan].view(torch.int64), b[~nan].view(torch.int64))


def _edge_tensor() -> torch.Tensor:
    vals = [s * v for v in EDGES for s in (1.0, -1.0)] + [math.nan]
    return torch.tensor(vals, dtype=F64)


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 14, 15, 16, 17, 18, 33, 129,
                               4097, (1 << 20) + 1))
def test_factor_table_expands_to_plain_factors(n):
    cp, denom = thomas.thomas_factors(n)
    want_cp, want_denom = ref.thomas_factors_ref(n)
    assert torch.equal(cp.view(torch.int64), want_cp.view(torch.int64))
    assert torch.equal(denom.view(torch.int64), want_denom.view(torch.int64))
    rows, h = thomas.factor_table(n)
    assert h == min(thomas.fixed_index(), n - 1) and len(rows) == h + 2
    for d, y, _ in rows:
        assert y == 1.0 / d and 0.5 <= d <= 4.0 / 3.0


def test_fixed_point_is_detected_not_assumed():
    k = thomas.fixed_index()
    cp, denom = ref.thomas_factors_ref(k + 8)
    # interior entries k-1 and k differ, k .. n-2 are all equal
    assert (cp[k - 1], denom[k - 1]) != (cp[k], denom[k])
    assert torch.equal(cp[k:-1], cp[k].expand(7)) and \
        torch.equal(denom[k:-1], denom[k].expand(7))
    # one table serves every line of K + 2 nodes or more
    assert thomas.factor_table(k + 2) == thomas.factor_table(1 << 23)


@pytest.mark.parametrize("d", DENOMS, ids=lambda d: d.hex())
def test_quotient_matches_division(d):
    y = 1.0 / d
    gen = torch.Generator().manual_seed(int(d * 2 ** 52) % 2 ** 31)
    n = 100_000
    mant = torch.rand(n, dtype=F64, generator=gen) + 1.0
    exp = torch.randint(-969, 1022, (n,), generator=gen)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    x = sign.to(F64) * torch.ldexp(mant, exp)
    assert ((x.abs() >= LO) & (x.abs() < HI)).all()
    assert _same(ref.thomas_quotient_ref(x, d, y), x / d)


def test_quotient_edges_match_division_with_the_guard():
    x = _edge_tensor()
    for d in DENOMS:
        y = 1.0 / d
        got = ref.thomas_quotient_ref(x, d, y)
        assert _same(got, x / d), d.hex()
        assert torch.equal(torch.signbit(got[x == 0]),
                           torch.signbit(x[x == 0]))
    # without the guard the sequence differs on this set: -0 becomes +0
    # (r = fma(-d, -0, -0) = +0), near-overflow x overflow to NaN
    d = DENOMS[0]
    y = 1.0 / d
    q = x * y
    bare = ref.fma_ref(ref.fma_ref(torch.full_like(x, -d), q, x),
                       torch.full_like(x, y), q)
    assert not _same(bare, x / d)


def _kernel_model(b: torch.Tensor) -> torch.Tensor:
    """The kernel's sweeps on (lines, n) rows: table rows per node and the
    guarded quotient, node by node across all lines at once."""
    n = b.shape[1]
    rows, h = thomas.factor_table(n)
    out = torch.empty_like(b)
    dp = torch.zeros(b.shape[0], dtype=F64)
    for i in range(n):
        d, y, _ = rows[h + 1] if i == n - 1 else rows[min(i, h)]
        x = ref.fma_ref(torch.full_like(dp, -ref.THOMAS_OFF), dp, b[:, i])
        dp = out[:, i] = ref.thomas_quotient_ref(x, d, y)
    z = dp
    for i in range(n - 2, -1, -1):
        c = rows[min(i, h)][2]
        z = out[:, i] = ref.fma_ref(torch.full_like(z, -c), z, out[:, i])
    return out


@pytest.mark.parametrize("n", (1, 2, 3, 15, 16, 17, 40))
def test_kernel_model_matches_plain_solve(n):
    rng = np.random.default_rng(n)
    b = rng.standard_normal((48, n)) * 10.0 ** rng.integers(-300, 300,
                                                            (48, n))
    edges = _edge_tensor().numpy()
    for r in range(len(edges)):
        b[r, rng.integers(0, n)] = edges[r]
    b = torch.from_numpy(b)
    assert _same(_kernel_model(b), thomas.thomas_solve_plain(b, 1))


@pytest.mark.parametrize("shape", ((1025,), (65, 33), (33, 31, 29)), ids=str)
def test_thomas_axis_and_projection_match_jit_past_the_table(shape):
    # project_detail solves on the coarse nodes, (s + 1) / 2 per axis
    assert min(shape) // 2 + 1 > thomas.fixed_index()
    b = np.random.default_rng(11).standard_normal(shape) * 10.0
    for ax in range(len(shape)):
        want = np.asarray(jax.jit(jortho._thomas_axis, static_argnums=1)(
            jnp.asarray(b), ax))
        got = tortho._thomas_axis(torch.from_numpy(b), ax)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # the plain sweeps on the expanded table give the same bits
        cp, denom = thomas.thomas_factors(shape[ax])
        np.testing.assert_array_equal(_bits(ref.thomas_solve_ref(
            torch.from_numpy(b), ax, cp, denom)), _bits(want))
    want = np.asarray(jax.jit(jortho.project_detail)(jnp.asarray(b)))
    np.testing.assert_array_equal(
        _bits(tortho.project_detail(torch.from_numpy(b))), _bits(want))


def test_cuda_entry_needs_cuda_tensor_or_cpu():
    b = torch.zeros(5, dtype=F64, device="meta")
    with pytest.raises(ValueError):
        thomas.thomas_solve(b, 0)
    with pytest.raises(TypeError):
        thomas.thomas_solve(torch.zeros(5, dtype=torch.float32), 0)
