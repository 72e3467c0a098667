"""The port's codec kernels against the JAX package, bit for bit.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held to the JAX Pallas kernels (interpret mode), the jnp oracles and the
JAX ``ops`` entry points on the same seeded inputs.  No tolerance: the codec
is integer-exact and its only float ops are exact.  The CUDA kernels are
held to the same plain versions by ``test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro._x64  # noqa: E402,F401  (float64 and uint64 in the reference)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitplane_pack import bitplane_pack as jax_pack  # noqa: E402
from repro.kernels.bitplane_unpack import bitplane_unpack as jax_unpack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.bitplane_pack import (bitplane_pack,  # noqa: E402
                                               bitplane_pack_plain)
from repro_torch.kernels.bitplane_unpack import bitplane_unpack  # noqa: E402

SIZES = (1, 31, 33, 1000, 4097)
PLANES = (0, 1, 47, 48)
NBITS = 48


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _f64_bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def _coeffs(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n) * np.exp(rng.uniform(-6, 6, size=n))
    c[rng.random(n) < 0.05] = 0.0
    return c


def _scale(c, nbits=NBITS):
    e = int(np.ceil(np.log2(np.max(np.abs(c)))))
    if 2.0 ** e == np.max(np.abs(c)):
        e += 1
    return float(np.float64(2.0) ** (nbits - e))


@pytest.mark.parametrize("nbits", (1, 17, 30, 32))
def test_pack_ref_matches_pallas_kernel_and_jnp_oracle(nbits):
    rng = np.random.default_rng(nbits)
    n = 1024                                   # one 8x128 Pallas tile
    mag = rng.integers(0, 2 ** nbits, size=n, dtype=np.int64)
    port = ref.bitplane_pack_ref(torch.from_numpy(mag), nbits)
    kern = jax_pack(jnp.asarray(mag.astype(np.uint32).view(np.int32)),
                    nbits=nbits, interpret=True)
    oracle = jref.bitplane_pack_ref(jnp.asarray(mag, jnp.int32), nbits)
    assert port.dtype == torch.int32 and port.shape == (nbits, n // 32)
    np.testing.assert_array_equal(_u32(port), np.asarray(kern))
    np.testing.assert_array_equal(_u32(port), np.asarray(oracle))


@pytest.mark.parametrize("n", SIZES)
def test_encode_matches_jax_encode_magnitude_planes(n):
    c = _coeffs(n, n)
    scale = _scale(c)
    want = jops.encode_magnitude_planes(c, scale, NBITS)
    got = ops.encode_magnitude_planes(torch.from_numpy(c), scale, NBITS)
    assert got.shape == (NBITS, (n + 31) // 32)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(bitplane_pack_plain(torch.from_numpy(c), scale, NBITS)), want)


@pytest.mark.parametrize("nplanes", (0, 1, 16, 31))
def test_unpack_ref_matches_pallas_kernel(nplanes):
    rng = np.random.default_rng(nplanes)
    words = rng.integers(0, 2 ** 32, size=(nplanes, 32), dtype=np.uint64
                         ).astype(np.uint32)
    shifts = rng.integers(0, 32, size=nplanes).astype(np.int64)
    port = ref.bitplane_unpack_ref(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(shifts))
    if nplanes:
        kern = np.asarray(jax_unpack(jnp.asarray(words),
                                     jnp.asarray(shifts, jnp.uint32),
                                     interpret=True))
        np.testing.assert_array_equal(port.numpy(), kern.astype(np.int64))
    oracle = np.asarray(jref.bitplane_unpack_ref(jnp.asarray(words),
                                                 jnp.asarray(shifts)))
    np.testing.assert_array_equal(port.numpy(), oracle.astype(np.int64))


def _planes_case(n, nplanes, seed):
    rng = np.random.default_rng(seed)
    nwords = (n + 31) // 32
    words = rng.integers(0, 2 ** 32, size=(nplanes, nwords),
                         dtype=np.uint64).astype(np.uint32)
    start = NBITS - nplanes if nplanes < NBITS else 0
    shifts = np.asarray([NBITS - 1 - b for b in range(start, start + nplanes)],
                        dtype=np.int64)
    return words, shifts


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nplanes", PLANES)
def test_unpack_bitplanes_matches_jax(n, nplanes):
    words, shifts = _planes_case(n, nplanes, 7 * n + nplanes)
    want = jops.unpack_bitplanes(words, shifts, n)
    got = ops.unpack_bitplanes(torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(shifts), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nplanes", PLANES)
def test_decode_values_fused_matches_jax(n, nplanes):
    words, shifts = _planes_case(n, nplanes, 11 * n + nplanes)
    rng = np.random.default_rng(n + nplanes)
    scale = 2.0 ** -37
    nbytes = (n + 7) // 8
    for carry in (False, True):
        state = None
        if carry:
            state = rng.integers(0, 2 ** NBITS, size=n, dtype=np.int64)
            state[rng.random(n) < 0.3] = 0
        for signs in ("pos", "neg", "mixed"):
            if signs == "mixed":
                sb = rng.integers(0, 256, size=nbytes).astype(np.uint8)
            else:
                sb = np.full(nbytes, 0 if signs == "pos" else 255, np.uint8)
            jmag, jvals = jops.decode_values_fused(
                words, shifts,
                None if state is None else state.astype(np.uint64), sb,
                scale, n)
            mag, vals = ops.decode_values_fused(
                words, shifts, None if state is None
                else torch.from_numpy(state), sb, scale, n,
                torch.device("cpu"))
            np.testing.assert_array_equal(
                mag.numpy(), np.asarray(jmag).astype(np.int64))
            np.testing.assert_array_equal(_f64_bits(vals.numpy()),
                                          _f64_bits(jvals))


def _general_shifts(kind, nplanes, rng):
    """Shifts that are not one descending run (the CUDA decode kernel's
    general path): distinct with holes in random order, every value twice,
    or all >= 32 with 63 among them."""
    if kind == "holes":
        s = rng.permutation(64)[:nplanes]
    elif kind == "duplicates":
        s = rng.integers(0, 64, nplanes)
        s[nplanes // 2:] = s[: nplanes - nplanes // 2]
    else:
        s = rng.integers(32, 64, nplanes)
        s[0] = 63
    return s.astype(np.int64)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ("holes", "duplicates", "high"))
def test_decode_values_fused_general_shifts_match_jax(n, kind):
    """The plain decode that the CUDA kernel's general shift path is held
    to on the card, against the JAX package: shifts out of order, with
    holes, duplicated, and up to 63 (bit 63 set: the magnitude is
    unsigned), with and without carry-in."""
    rng = np.random.default_rng(13 * n + len(kind))
    nwords = (n + 31) // 32
    scale = 2.0 ** -37
    sb = rng.integers(0, 256, size=(n + 7) // 8).astype(np.uint8)
    for nplanes in (2, 33, 64):
        words = rng.integers(0, 2 ** 32, size=(nplanes, nwords),
                             dtype=np.uint64).astype(np.uint32)
        shifts = _general_shifts(kind, nplanes, rng)
        assert any(int(s) != int(shifts[0]) - j for j, s in enumerate(shifts))
        for state in (None, rng.integers(0, 2 ** 62, size=n, dtype=np.int64)):
            jmag, jvals = jops.decode_values_fused(
                words, shifts,
                None if state is None else state.astype(np.uint64), sb,
                scale, n)
            mag, vals = ops.decode_values_fused(
                words, shifts, None if state is None
                else torch.from_numpy(state), sb, scale, n,
                torch.device("cpu"))
            np.testing.assert_array_equal(
                mag.numpy(), np.asarray(jmag).astype(np.int64))
            np.testing.assert_array_equal(_f64_bits(vals.numpy()),
                                          _f64_bits(jvals))


def test_zero_planes_are_a_no_op_copy_of_state():
    state = torch.arange(64, dtype=torch.int64) * 12345
    words = torch.zeros((0, 2), dtype=torch.int32)
    shifts = torch.zeros(0, dtype=torch.int64)
    mag, vals = bitplane_unpack(words, shifts, state)
    assert vals is None and torch.equal(mag, state)
    assert mag.data_ptr() != state.data_ptr()     # state is never aliased


def test_pack_wrapper_rejects_bad_inputs():
    c = torch.zeros(64, dtype=torch.float64)
    with pytest.raises(TypeError):
        bitplane_pack(c.to(torch.float32), 1.0, NBITS)
    with pytest.raises(ValueError):
        bitplane_pack(c.reshape(8, 8), 1.0, NBITS)
    with pytest.raises(ValueError):
        bitplane_pack(torch.zeros(128, dtype=torch.float64)[::2], 1.0, NBITS)
    with pytest.raises(ValueError):
        bitplane_pack(c, 1.0, 54)


def test_unpack_wrapper_rejects_bad_inputs():
    w = torch.zeros((2, 4), dtype=torch.int32)
    s = torch.tensor([47, 46], dtype=torch.int64)
    with pytest.raises(TypeError):
        bitplane_unpack(w.to(torch.int64), s)
    with pytest.raises(TypeError):
        bitplane_unpack(w, s.to(torch.int32))
    with pytest.raises(ValueError):
        bitplane_unpack(w[0], s)                       # not (P, W)
    with pytest.raises(ValueError):
        bitplane_unpack(w, s[:1])                      # shifts length
    with pytest.raises(ValueError):
        bitplane_unpack(torch.zeros((2, 8), dtype=torch.int32)[:, ::2], s)
    with pytest.raises(ValueError):
        bitplane_unpack(w, s, torch.zeros(5, dtype=torch.int64))
    with pytest.raises(TypeError):
        bitplane_unpack(w, s, torch.zeros(128, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitplane_unpack(w, s, None, torch.zeros(3, dtype=torch.uint8))
    with pytest.raises(TypeError):
        bitplane_unpack(w, s, None, torch.zeros(16, dtype=torch.int8))
    with pytest.raises(ValueError):
        bitplane_unpack(w, torch.tensor([64, 0], dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.decode_values_fused(np.zeros((1, 1), np.uint32), [64], None,
                                np.zeros(4, np.uint8), 1.0, 32,
                                torch.device("cpu"))
