"""The port's HB transform against the JAX package, bit for bit.

Every op of the transform is elementwise IEEE float64 in both packages
(``0.5 * (lo + hi)``, ``view ± pred``, ``where``), so decompose, recompose,
the partial recompose and the reader's scatter + partial recompose must
agree to the last bit on every shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.transform import hierarchical as jh  # noqa: E402
from repro_torch.transform import hierarchical as th  # noqa: E402

SHAPES = ((65,), (33, 33), (17, 17, 17), (129, 65), (10, 7))


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, size=shape))
    padded, orig = jh.pad_to_grid(x)
    return padded, orig, jh.grid_levels(padded.shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_helpers_match(shape):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    pj, oj = jh.pad_to_grid(x)
    pt, ot = th.pad_to_grid(x)
    assert oj == ot and np.array_equal(pj, pt)
    levels = jh.grid_levels(pj.shape)
    assert th.grid_levels(pt.shape) == levels
    assert np.array_equal(jh.level_map(pj.shape, levels),
                          th.level_map(pt.shape, levels))
    assert np.array_equal(jh.unpad(pj, oj), th.unpad(pt, ot))


@pytest.mark.parametrize("shape", ((2 ** 16 + 1,), (17, 33), (9, 17, 33),
                                   (65, 3), (3,)))
def test_level_map_equals_the_reference_at_every_level_count(shape):
    """The port's one-pass ``_v2`` (lowest set bit) against the reference's
    halving loop: equal valuations on 1 .. 2^20 and on large seeded ints,
    and equal level maps at every level count a grid takes."""
    idx = np.concatenate([np.arange(1, 1 << 20),
                          np.random.default_rng(0).integers(1, 2 ** 52,
                                                            1 << 12)])
    got, want = th._v2(idx), jh._v2(idx)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for levels in range(jh.grid_levels(shape) + 1):
        want = jh.level_map(shape, levels)
        got = th.level_map(shape, levels)
        assert got.dtype == want.dtype and np.array_equal(got, want), levels


@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_and_recompose_bit_identical(shape):
    x, _, levels = _field(shape, len(shape))
    cj = np.asarray(jh.decompose_hb(x, levels))
    ct = th.decompose_hb(torch.from_numpy(x), levels)
    np.testing.assert_array_equal(_bits(ct.numpy()), _bits(cj))
    rj = np.asarray(jh.recompose_hb(cj, levels))
    rt = th.recompose_hb(torch.from_numpy(cj.copy()), levels)
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    # the input is never modified
    np.testing.assert_array_equal(_bits(th.decompose_hb(
        torch.from_numpy(x), levels).numpy()), _bits(cj))


@pytest.mark.parametrize("shape", SHAPES)
def test_partial_and_scatter_recompose_bit_identical(shape):
    x, _, levels = _field(shape, 10 + len(shape))
    coeffs = np.asarray(jh.decompose_hb(x, levels))
    lmap = jh.level_map(x.shape, levels).ravel()
    # finest detail level, a middle one, and the base group (index L)
    for l in sorted({0, levels // 2, levels}):
        idx = np.flatnonzero(lmap == l)
        vals = coeffs.ravel()[idx]
        start = min(l, levels - 1)
        flat = np.zeros(x.size)
        flat[idx] = vals
        pj = np.asarray(jh.recompose_hb_from(flat.reshape(x.shape), levels,
                                             start))
        pt = th.recompose_hb_from(torch.from_numpy(flat.reshape(x.shape)),
                                  levels, start)
        np.testing.assert_array_equal(_bits(pt.numpy()), _bits(pj))
        sj = np.asarray(jh.scatter_recompose_from(
            jnp.asarray(idx), jnp.asarray(vals), x.shape, levels, start))
        st = th.scatter_recompose_from(torch.from_numpy(idx),
                                       torch.from_numpy(vals), x.shape,
                                       levels, start)
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


def test_hb_error_bound_matches():
    bounds = [1e-3, 2.5e-4, 7e-9, 0.0]
    assert th.hb_error_bound(bounds) == jh.hb_error_bound(bounds)
