"""Fault C3: the port rounds its QoI values and bounds as the reference's
retrieval does, under ``jax.jit``, where XLA's CPU backend fuses a multiply
feeding an add into one fused multiply-add.

Held here, on the CPU:

* the exact fused multiply-add emulation (``kernels/ref.py::fma_ref``, the
  plain version of the CUDA kernel ``fma_rn``) against rational arithmetic
  on 100k seeded triples and on inf, NaN, signed zeros, overflow, underflow
  and cancellation;
* a probe that XLA on this host still contracts ``2|x|ε + ε²`` into
  ``fma(2|x|, ε, ε·ε)`` — the placements below are that compiler's;
* each of the six GE QoIs, loose and ``tight=True``, value and bound bit
  for bit against ``jax.jit`` of the reference's ``expr.eval``;
* retrieval on the tight QoIs at τ_rel 1e-9 and 1e-12 over five shapes:
  per-iteration eps, ``bytes_retrieved`` and est_errors exactly equal;
* seeded random expression trees, which the bit-for-bit claim does not
  cover (the side an add fuses when both operands are products was
  observed for the GE trees only): value and bound within the stated
  ``TREE_RTOL`` of ``jax.jit``, and +inf/NaN where the reference has them.
"""
import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.core import ge as jge  # noqa: E402
from repro.core import qoi as jqoi  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data.synthetic import ge_like_fields  # noqa: E402
from repro_torch.core import ge as tge  # noqa: E402
from repro_torch.core import qoi as tqoi  # noqa: E402
from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.core.retrieval import QoIRequest, retrieve_qoi_controlled  # noqa: E402
from repro_torch.kernels.fma import fma  # noqa: E402
from repro_torch.kernels.ref import fma_scalar  # noqa: E402

QOIS = ("VTOT", "T", "C", "Mach", "PT", "mu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _ieee_fma(a: float, b: float, c: float) -> float:
    """a*b + c rounded once, from rationals, with IEEE's special values and
    signed zeros."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return a * b + c
    if not math.isfinite(c):
        return c
    if a == 0 or b == 0:
        return a * b + c          # the product is an exact signed zero
    r = Fraction(a) * Fraction(b) + Fraction(c)
    if r == 0:
        return 0.0                # exact cancellation rounds to +0
    try:
        return float(r)
    except OverflowError:
        return math.inf if r > 0 else -math.inf


def _same(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Elementwise bit-equality, any NaN matching any NaN."""
    return (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))


def _random_triples(n: int, seed: int):
    """Products over 120 binades and addends that range from unrelated to
    cancelling the product exactly, to the ulp, and to half an ulp."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    ab = a * b
    kind = rng.integers(0, 5, n)
    c = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [rng.standard_normal(n) * 2.0 ** rng.integers(-130, 130, n),
         -ab,
         -ab * (1 + rng.integers(-4, 5, n) * 2.0 ** -52),
         -ab + ab * 2.0 ** -53 * rng.integers(-3, 4, n)],
        ab * 2.0 ** rng.integers(-110, -50, n))
    return a, b, c


EDGES = [
    (1e300, 1e10, -1e308), (2.0 ** 1000, 2.0 ** 20, -2.0 ** 1020),
    (1e308, 1e308, 0.0), (-1e308, 1e308, 1.0), (1e200, 1e200, -1e308),
    (1e-200, 1e-200, 1e-320), (1e-160, 1e-160, -1e-320),
    (2.0 ** -537, 2.0 ** -537, 2.0 ** -1074), (5e-324, 0.5, 0.0),
    (1.5, 2.0 ** -1074, 0.0), (2.0 ** 600, 2.0 ** -600, -1.0),
    (3.0, 1.0 / 3.0, -1.0), (0.1, 10.0, -1.0),
    (-0.0, 1.0, -0.0), (0.0, -1.0, 0.0), (-0.0, 0.0, 0.0), (0.0, 0.0, -0.0),
    (-0.0, -0.0, -0.0), (1.0, -1.0, 1.0), (2.0, 3.0, -6.0),
    (math.inf, 0.0, 1.0), (math.inf, 2.0, -math.inf), (math.inf, 2.0, 1.0),
    (1e308, 10.0, -math.inf), (1.0, 1.0, math.inf),
    (math.nan, 1.0, 1.0), (1.0, 1.0, math.nan), (0.0, math.nan, 0.0),
]


@pytest.mark.parametrize("seed", range(4))
def test_fma_emulation_matches_rationals(seed):
    a, b, c = _random_triples(25_000, seed)
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    want = np.array([_ieee_fma(*t) for t in zip(a, b, c)])
    assert _same(got, want).all()
    # the cases where one rounding differs from two are well represented
    assert ((a * b + c) != want).mean() > 0.3


def test_fma_emulation_edge_cases():
    a, b, c = (np.array(v, dtype=np.float64) for v in zip(*EDGES))
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    want = np.array([_ieee_fma(*t) for t in EDGES])
    bad = [EDGES[i] for i in np.flatnonzero(~_same(got, want))]
    assert not bad, f"fma emulation wrong at {bad}"


def test_fma_scalar_matches_tensor_emulation():
    a, b, c = _random_triples(5_000, 11)
    a = np.concatenate([a, [t[0] for t in EDGES]])
    b = np.concatenate([b, [t[1] for t in EDGES]])
    c = np.concatenate([c, [t[2] for t in EDGES]])
    want = fma(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(c)).numpy()
    got = np.array([fma_scalar(*t) for t in zip(a.tolist(), b.tolist(),
                                                 c.tolist())])
    assert _same(got, want).all()


def test_fma_broadcasts_scalars_and_refuses_other_devices():
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert torch.equal(fma(2.0, x, 1.0), 2.0 * x + 1.0)
    with pytest.raises(TypeError):
        fma(x.float(), x, x)
    m = torch.zeros(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fma(m, m, m)


def test_xla_contracts_like_an_fma3_host():
    """The port's placements are those of XLA's CPU backend on an x86-64
    host with FMA3.  If ``jax.jit`` of the intpow bound stops being
    fma(2|x|, ε, ε·ε), the compiler changed and every placement in
    ``core/estimators.py``, ``core/qoi.py``, ``core/ge.py`` and
    ``transform/orthogonal.py`` must be re-derived (ROADMAP C3)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2000) * 10
    e = np.abs(rng.standard_normal(2000)) * 1e-3
    got = np.asarray(jax.jit(lambda x, e: 2 * jnp.abs(x) * jnp.where(
        jnp.isinf(e), 0.0, e) + jnp.where(jnp.isinf(e), 0.0, e) ** 2)(x, e))
    model = np.array([_ieee_fma(2 * abs(p), q, q * q) for p, q in zip(x, e)])
    eager = 2 * np.abs(x) * e + e * e
    assert (eager != model).sum() > 100, "probe inputs do not discriminate"
    mismatches = int((_bits(got) != _bits(model)).sum())
    assert mismatches == 0, (
        f"jax.jit of 2|x|e + e^2 no longer equals fma(2|x|, e, e*e) at "
        f"{mismatches} of 2000 inputs: XLA's CPU contraction changed; "
        f"re-derive the port's fma placements (ROADMAP C3)")


@pytest.fixture(scope="module")
def ge_fields():
    f = ge_like_fields(n=4096, seed=0)
    return {k: np.asarray(v, dtype=np.float64) for k, v in f.items()}


@pytest.mark.parametrize("tight", (False, True), ids=("loose", "tight"))
@pytest.mark.parametrize("name", QOIS)
def test_ge_qoi_bit_equal_to_jit(ge_fields, name, tight):
    rng = np.random.default_rng(QOIS.index(name) + 10 * tight)
    jexpr = jge.all_qois(tight=tight)[name]
    texpr = tge.all_qois(tight=tight)[name]
    fn = jax.jit(lambda v, e: jexpr.eval(v, e))
    tvals = {k: torch.from_numpy(v) for k, v in ge_fields.items()}
    for c in (1e-2, 1e-6, 1e-9, 1e-12):
        ebs = {k: np.abs(rng.standard_normal(v.size)) * c
               * (np.max(v) - np.min(v)) for k, v in ge_fields.items()}
        ebs["Vy"][:64] = 0.0                       # exact points
        jv, jb = fn(ge_fields, ebs)
        tv, tb = texpr.eval(tvals, {k: torch.from_numpy(v)
                                    for k, v in ebs.items()})
        np.testing.assert_array_equal(_bits(tv), _bits(jv))
        np.testing.assert_array_equal(_bits(tb), _bits(jb))


SHAPES = ((17, 33), (9, 10, 11), (100,), (65, 3), (5,))


@pytest.mark.parametrize("tau", (1e-9, 1e-12))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tight_retrieval_matches_jax(shape, tau):
    n = int(np.prod(shape))
    fields = {k: np.asarray(v).reshape(shape)
              for k, v in ge_like_fields(n=n, seed=1).items()}
    jres = jax_retrieve(jax_refactor(fields).open(),
                        [JaxRequest(q, e, tau)
                         for q, e in jge.all_qois(tight=True).items()])
    tres = retrieve_qoi_controlled(
        refactor_variables(fields, device="cpu").open(),
        [QoIRequest(q, e, tau) for q, e in tge.all_qois(tight=True).items()])
    assert tres.converged == jres.converged
    assert tres.bytes_retrieved == jres.bytes_retrieved
    assert len(tres.iterations) == len(jres.iterations)
    for ti, ji in zip(tres.iterations, jres.iterations):
        assert ti.eps == ji.eps
        assert ti.bytes_retrieved == ji.bytes_retrieved
        assert ti.est_errors == ji.est_errors
        assert ti.tau_abs == ji.tau_abs
    assert tres.est_errors == jres.est_errors
    for k, v in jres.values.items():
        np.testing.assert_array_equal(_bits(tres.values[k]), _bits(v))


# Out-of-catalog trees: the port's default placements against jax.jit.  A
# misplaced fusion changes one add by its last place; a cancelling Sum or a
# tight Sqrt amplifies that.  Observed on these trees (jax 0.9.0, CPU): 80
# of 96 values and 82 of 96 bounds bit-equal, the rest within 5.5e-16 and
# 6.5e-16 relative; XLA's other rewrites (it folds sqrt(x)·sqrt(x) into x)
# count here too.
TREE_RTOL = 1e-12
TREE_VARS = ("Vx", "Vy", "Vz", "P", "D")


def _random_tree(rng, depth):
    """One random expression, built alike in both packages: (ref, port)."""
    kind = int(rng.integers(0, 8)) if depth > 0 else int(rng.integers(0, 2))
    if kind == 0 or (depth == 0 and rng.random() < 0.7):
        name = TREE_VARS[int(rng.integers(0, 5))]
        return jqoi.Var(name), tqoi.Var(name)
    if kind == 1:
        c = float(rng.choice([0.5, 2.0, 3.7, -1.25]))
        return jqoi.Const(c), tqoi.Const(c)
    kids = [_random_tree(rng, depth - 1) for _ in range(
        int(rng.integers(1, 4)) if kind == 2 else 1 + (kind in (3, 4)))]
    j, t = [k[0] for k in kids], [k[1] for k in kids]
    if kind == 2:
        coeffs = tuple(float(c) for c in rng.choice(
            [1.0, -1.0, 0.5, 2.5, -3.0], len(j))) if rng.random() < 0.7 \
            else None
        const = float(rng.choice([0.0, 1.0, 0.3]))
        return (jqoi.Sum(j, coeffs, const), tqoi.Sum(t, coeffs, const))
    if kind in (3, 4):
        cls = ("Prod", "Quot")[kind - 3]
        return getattr(jqoi, cls)(*j), getattr(tqoi, cls)(*t)
    if kind == 5:
        n = int(rng.integers(1, 5))
        return jqoi.IntPow(j[0], n), tqoi.IntPow(t[0], n)
    if kind == 6:
        tight = bool(rng.random() < 0.5)
        return jqoi.Sqrt(j[0], tight), tqoi.Sqrt(t[0], tight)
    c = float(rng.choice([0.0, 110.4, 2.0]))
    return jqoi.Radical(j[0], c), tqoi.Radical(t[0], c)


@pytest.mark.parametrize("seed", range(6))
def test_random_trees_within_stated_tolerance(seed):
    f = {k: np.asarray(v, dtype=np.float64)
         for k, v in ge_like_fields(n=512, seed=seed).items()}
    tvals = {k: torch.from_numpy(v) for k, v in f.items()}
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        jexpr, texpr = _random_tree(rng, 3)
        fn = jax.jit(lambda v, e: jexpr.eval(v, e))
        for c in (1e-3, 1e-9):
            ebs = {k: np.abs(rng.standard_normal(v.size)) * c
                   * (np.max(v) - np.min(v)) for k, v in f.items()}
            jv, jb = fn(f, ebs)
            with np.errstate(all="ignore"):
                tv, tb = texpr.eval(tvals, {k: torch.from_numpy(v)
                                            for k, v in ebs.items()})
            for got, want in ((tv.numpy(), jv), (tb.numpy(), jb)):
                want = np.broadcast_to(np.asarray(want), got.shape)
                np.testing.assert_array_equal(np.isfinite(got),
                                              np.isfinite(want))
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
                fin = np.isfinite(want)
                np.testing.assert_allclose(got[fin], want[fin],
                                           rtol=TREE_RTOL, atol=0,
                                           err_msg=repr(texpr))


# Fault C4: temperature's bound, Quot(P, scale(D, R)), on multi-D fields.
# Which product of the numerator's add XLA fuses depends on how LLVM
# vectorizes the fused loop for that shape (both sides occur within one
# field, by element position, and the split changes with the shape and with
# the vectorizer's cost model), so the port keeps one placement and states
# its scope: bit for bit on 1-D fields; on multi-D fields the bound within
# T_BOUND_ULPS units in the last place of `jax.jit`'s (the numerator is
# rounded once differently, and the division can carry that to two ulps of
# the quotient), values bit for bit, and retrieval decisions identical.
T_BOUND_ULPS = 2
C4_SHAPES = ((4, 3), (8, 3), (4, 5), (16, 7), (65, 3), (100, 3), (1000, 3),
             (4, 1, 3), (4, 3, 1), (12,), (257,), (4096,), (3, 4), (5, 3),
             (2, 3), (6, 7), (17, 33), (33, 17), (64, 64), (9, 10, 11),
             (16, 16, 16), (33, 33, 17), (33, 33, 33))


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in units of the spacing at the smaller magnitude."""
    low = np.minimum(np.abs(got), np.abs(want))
    return np.abs(got - want) / np.spacing(low)


@pytest.mark.parametrize("shape", C4_SHAPES, ids=str)
def test_temperature_bound_within_stated_ulps(shape):
    n = int(np.prod(shape))
    fn = jax.jit(lambda v, e: jge.temperature().eval(v, e))
    texpr = tge.temperature()
    for kind in range(3):
        f = {k: np.asarray(v).reshape(shape)
             for k, v in ge_like_fields(n=n, seed=kind).items()
             if k in ("P", "D")}
        rng = np.random.default_rng(7 + kind)
        for _ in range(4):
            ebs = {k: 10.0 ** rng.uniform(-12, -1) * np.ptp(v)
                   * rng.uniform(0.5, 2.0, shape) for k, v in f.items()}
            jv, jb = (np.asarray(a) for a in fn(f, ebs))
            tv, tb = (a.numpy() for a in texpr.eval(
                {k: torch.from_numpy(v) for k, v in f.items()},
                {k: torch.from_numpy(v) for k, v in ebs.items()}))
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
            if len(shape) == 1:
                np.testing.assert_array_equal(_bits(tb), _bits(jb))
                continue
            np.testing.assert_array_equal(np.isfinite(tb), np.isfinite(jb))
            fin = np.isfinite(jb)
            assert _ulps_apart(tb[fin], jb[fin]).max(initial=0.0) \
                <= T_BOUND_ULPS


@pytest.mark.parametrize("method,tau", (("hb", 1e-8), ("ip", 1e-8),
                                        ("ob", 1e-8), ("psz3", 1e-1),
                                        ("psz3", 1e-4),
                                        ("psz3_delta", 1e-1)))
def test_temperature_retrieval_on_4_1_3(method, tau):
    """The shape on which C4 moved est_errors through retrieval: the same
    eps, bytes, iterations, convergence and values; est_errors held to the
    bound's bar."""
    for seed in range(4):
        fields = {k: np.asarray(v).reshape(4, 1, 3)
                  for k, v in ge_like_fields(n=12, seed=seed).items()}
        jres = jax_retrieve(jax_refactor(fields, method=method).open(),
                            [JaxRequest("T", jge.temperature(), tau)])
        tres = retrieve_qoi_controlled(
            refactor_variables(fields, method=method, device="cpu").open(),
            [QoIRequest("T", tge.temperature(), tau)])
        assert tres.converged == jres.converged
        assert tres.bytes_retrieved == jres.bytes_retrieved
        assert len(tres.iterations) == len(jres.iterations)
        for ti, ji in zip(tres.iterations, jres.iterations):
            assert ti.eps == ji.eps
            assert ti.bytes_retrieved == ji.bytes_retrieved
            assert ti.tau_abs == ji.tau_abs
            assert _ulps_apart(np.float64(ti.est_errors["T"]),
                               np.float64(ji.est_errors["T"])) \
                <= T_BOUND_ULPS
        for k, v in jres.values.items():
            np.testing.assert_array_equal(_bits(tres.values[k]), _bits(v))
