"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package.

Same parameters (the reference's init, carried across as numpy), same
seeded gradients and batches.  What each comparison holds:

* ``compress_decompress``: codes, outputs and feedback bit for bit (the
  reference jit'd, as its trainer runs it); the exponent and scale
  tables that close fault C6 regenerated from the reference, and codes,
  scale and feedback bit for bit over every amax within 96 ulps of each
  power of two;
* ``clip_by_global_norm``: bit for bit on the fixture's draw; on other
  draws within ``OPT_ULPS`` float32 ulps (each leaf's float32 sum of
  squares runs in another order than XLA's: on 14 of 20 seeded draws the
  norm is 1 or 2 ulps off, and the clipped leaves up to 2.65 ulps of the
  leaf's largest magnitude);
* AdamW and Adafactor over 3 steps: parameters and state within
  ``OPT_ULPS`` float32 ulps of each leaf's largest magnitude (the
  reference's step is one ``jax.jit``, where XLA contracts multiply-adds
  into FMAs and computes ``pow`` its own way; measured: under 2.1);
* checkpoints: planes and signs byte-identical to the reference's
  ``save_checkpoint`` of the same tree; restores at tau 0, 1e-4 and 1e-2
  bit-equal, with equal ``bytes_moved``, ``bytes_full`` and
  ``tensor_bounds``, and ``rms_bounds`` within rtol 1e-14 (means summed
  in another order);
* the train step over 3 steps: losses within rtol 1e-5.
"""
import math
import multiprocessing
import pickle
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro._x64  # noqa: E402,F401  (the reference trainer's mode)
from repro import configs as ref_configs  # noqa: E402
from repro.data.batches import make_train_batch as ref_batch  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import grad_compress as RG  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_step  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bitplane import encoder  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.data.batches import make_train_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import grad_compress as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.fault import (FailureInjector,  # noqa: E402
                                     StragglerPolicy, run_with_failures)
from repro_torch.train.pytree import (flatten_with_paths,  # noqa: E402
                                      tree_from_paths, tree_leaves,
                                      tree_unflatten_like)
from repro_torch.train.train_step import make_train_step  # noqa: E402

NAME = "internlm2-1.8b"
OPT_ULPS = 4.0
# fault C6 (fixed): the reference's exponent and scale, tabled by the port,
# from e = -99 (the clamp at 1e-30) to 128 (inf), checked over every amax
# within C6_BAND_ULPS ulps of each 2^k
C6_E_MIN, C6_E_MAX = -99, 128
C6_BAND_ULPS = 96


def _leaf_tensor(a) -> torch.Tensor:
    """A numpy leaf (bfloat16 ones included) as a tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _params(cfg, rng):
    """Seeded numpy weights in the reference's tree (its leaves, shapes and
    dtypes, from ``jax.eval_shape`` of its init) at its init's scales: ones
    for norm scales, normal times ``shape[-2] ** -0.5`` but 1 for the
    embedding table."""
    shapes = jax.eval_shape(
        lambda: RT.init_params(jax.random.PRNGKey(0), cfg))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(s.shape, s.dtype)
        z = rng.standard_normal(s.shape)
        return (z if "embed" in name else z * s.shape[-2] ** -0.5
                ).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    """Reduced internlm2 params (float32, seeded, in the reference's tree),
    three seeded gradient trees at mixed scales, and a bfloat16 copy of the
    params."""
    cfg = ref_configs.get_reduced(NAME)
    params = _params(cfg, np.random.default_rng(1))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * 10.0 ** rng.integers(-4, 1)
                                     ).astype(np.float32), params)
             for _ in range(3)]
    bf16 = _np(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params))
    return cfg, params, grads, bf16


def _scaled_ulps(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m = np.abs(b).max()
    return float(np.abs(a - b).max() / (m * 2.0 ** -23)) if m else \
        float(np.abs(a - b).max())


# ------------------------------------------------------------ optimizers --

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_three_steps_match_the_reference(setup, name):
    _, params, grads, _ = setup
    rinit, rupd = RO.make_optimizer(name)
    pinit, pupd = O.make_optimizer(name)
    ref_step = jax.jit(lambda p, g, s: rupd(p, g, s, lr=3e-3))
    rp = jax.tree.map(jnp.asarray, params)
    rs = rinit(rp)
    tp = _torch(params)
    ts = pinit(tp)
    for g in grads:
        rp, rs = ref_step(rp, jax.tree.map(jnp.asarray, g), rs)
        tp, ts = pupd(tp, _torch(g), ts, lr=3e-3)
    assert int(ts.step) == int(rs.step) == 3 and ts.step.dtype == torch.int32
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(rp)):
        assert _scaled_ulps(a, b) <= OPT_ULPS
    ref_state = jax.tree.leaves(rs.inner)
    assert len(tree_leaves(ts.inner)) == len(ref_state)
    for a, b in zip(tree_leaves(ts.inner), ref_state):
        assert tuple(a.shape) == b.shape
        assert _scaled_ulps(a, b) <= OPT_ULPS


def test_clip_by_global_norm_is_bit_equal(setup):
    """Bit for bit on this draw; not on every draw (see the next test)."""
    _, _, grads, _ = setup
    for max_norm in (1e-3, 1.0, 1e3):
        rc, rn = jax.jit(RO.clip_by_global_norm, static_argnums=1)(
            jax.tree.map(jnp.asarray, grads[0]), max_norm)
        tc, tn = O.clip_by_global_norm(_torch(grads[0]), max_norm)
        assert float(tn) == float(rn)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(rc)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    # the reference's own check: the clipped norm is at most max_norm
    tc, _ = O.clip_by_global_norm(_torch(grads[0]), 1e-3)
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in tree_leaves(tc)))
    assert norm <= 1e-3 * (1 + 1e-5)


@pytest.mark.parametrize("seed", [10, 24, 28])
def test_clip_by_global_norm_within_ulps_on_other_draws(setup, seed):
    """Draws where the port's global norm is 1, 2 and 2 float32 ulps off
    ``jax.jit``'s: the norm and the clipped leaves stay within
    ``OPT_ULPS``."""
    _, params, _, _ = setup
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 10.0 ** rng.integers(-4, 1)
                                    ).astype(np.float32), params)
    clip = jax.jit(RO.clip_by_global_norm, static_argnums=1)
    for max_norm in (1e-3, 1.0, 1e3):
        rc, rn = clip(jax.tree.map(jnp.asarray, grads), max_norm)
        tc, tn = O.clip_by_global_norm(_torch(grads), max_norm)
        assert abs(float(tn) - float(rn)) <= \
            OPT_ULPS * float(np.spacing(np.float32(rn)))
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(rc)):
            assert _scaled_ulps(a, b) <= OPT_ULPS


# ---------------------------------------------------------- grad compress --

def test_compress_decompress_codes_outputs_and_feedback_exact(setup):
    _, params, grads, _ = setup
    ref = jax.jit(RG.compress_decompress, static_argnums=2)
    for k in (4, 8):
        rfb = RG.zeros_like_feedback(jax.tree.map(jnp.asarray, params))
        tfb = G.zeros_like_feedback(_torch(params))
        for g in grads:
            rc, rfb = ref(jax.tree.map(jnp.asarray, g), rfb, k)
            tc, tfb = G.compress_decompress(_torch(g), tfb, k)
            for a, b in zip(tree_leaves(tc) + tree_leaves(tfb),
                            jax.tree.leaves(rc) + jax.tree.leaves(rfb)):
                assert a.dtype == torch.float32
                assert np.array_equal(a.numpy(), np.asarray(b))
        codes = jax.jit(lambda t: jax.tree.map(
            lambda x: RG._quantise(x, k), t))(
                jax.tree.map(jnp.asarray, grads[0]))
        for leaf, (rq, rs) in zip(jax.tree.leaves(grads[0]),
                                  jax.tree.leaves(codes, is_leaf=lambda x:
                                                  isinstance(x, tuple))):
            tq, ts = G._quantise(torch.from_numpy(leaf), k)
            assert tq.dtype == torch.int32 and float(ts) == float(rs)
            assert np.array_equal(tq.numpy(), np.asarray(rq))


def test_quantise_exponent_at_powers_of_two_and_c6():
    """amax exactly at, and one ulp either side of, 2^k for every k the
    clamp lets through: codes and scale equal the reference's.  Fault C6
    (torch's float32 log and exp against XLA's) left 13 exponents here
    where they did not; the tables close it, so the set is empty."""
    ref = jax.jit(RG._quantise, static_argnums=1)
    mismatched = set()
    for k in range(-99, 128):
        p = np.float32(2.0) ** k
        for side, a in ((-1, np.nextafter(p, np.float32(0))), (0, p),
                        (1, np.nextafter(p, np.float32(np.inf)))):
            if not np.isfinite(a):
                continue
            g = np.array([a, -a / 3, a / 7, 0.0], np.float32)
            rq, rs = ref(jnp.asarray(g), 8)
            tq, ts = G._quantise(torch.from_numpy(g), 8)
            if float(ts) != float(rs) or \
                    not np.array_equal(tq.numpy(), np.asarray(rq)):
                mismatched.add((k, side))
    assert mismatched == set()


def _ref_scalar_quantise():
    """The reference's ``_quantise`` as its train step runs it: jitted, on
    one leaf whose amax is a 0-d value inside the step."""
    ref = jax.jit(RG._quantise, static_argnums=1)
    return lambda a: ref(jnp.asarray(np.array([a], np.float32)), 8)


def _bits_of(x) -> int:
    return int(np.float32(x).view(np.int32)) & 0xFFFFFFFF


def test_quantise_tables_equal_the_reference():
    """Regenerate ``_SCALE_BITS`` (the scale of an amax inside each
    exponent's band, 0 for e = -99 and float32's max for e = 128) and
    ``_E_EDGE_BITS`` (bisection over bit patterns within 4096 ulps of
    2^k for the largest amax whose scale is still e's) from scalar calls
    of the jitted reference, and hold the port's literals to them."""
    quant = _ref_scalar_quantise()
    scale_of = {}
    for e in range(C6_E_MIN, C6_E_MAX + 1):
        a = np.float32(0.0) if e == C6_E_MIN else \
            np.finfo(np.float32).max if e == C6_E_MAX else \
            np.float32(0.75) * np.float32(2.0) ** e
        scale_of[e] = _bits_of(quant(a)[1])
    assert [scale_of[e] for e in sorted(scale_of)] == list(G._SCALE_BITS)
    exponent = {b: e for e, b in scale_of.items()}
    assert len(exponent) == len(scale_of)        # one scale per exponent

    def e_at(bits: int) -> int:
        return exponent[_bits_of(quant(np.int32(bits).view(np.float32))[1])]

    edges = []
    for k in range(C6_E_MIN, C6_E_MAX):
        lo = _bits_of(np.float32(2.0) ** k) - 4096
        hi = lo + 8192
        assert e_at(lo) <= k < e_at(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if e_at(mid) <= k else (lo, mid)
        edges.append(lo)
    assert edges == list(G._E_EDGE_BITS)


def _band(k: int, ulps: int = C6_BAND_ULPS) -> np.ndarray:
    """Every finite float32 within ``ulps`` ulps of 2^k."""
    b = _bits_of(np.float32(2.0) ** k)
    a = np.arange(b - ulps, b + ulps + 1).astype(np.int32).view(np.float32)
    return a[np.isfinite(a)]


def test_quantise_codes_scale_and_feedback_bit_equal_over_the_bands():
    """Every amax within 96 ulps of 2^k, k in [-99, 127] (43,811 values):
    the port's codes, scale, compressed output and feedback bit-equal to
    scalar calls of the jitted reference."""
    def ref_fn(g):
        comp, fb = RG.compress_decompress(g, jnp.zeros_like(g), 8)
        return RG._quantise(g, 8), comp, fb
    ref = jax.jit(ref_fn)
    n = 0
    for k in range(C6_E_MIN, C6_E_MAX):
        for a in _band(k):
            g = np.array([a, -a / 3, a / 7, 0.0], np.float32)
            (rq, rs), rc, rfb = ref(jnp.asarray(g))
            tg = torch.from_numpy(g)
            tq, ts = G._quantise(tg, 8)
            tc, tfb = G.compress_decompress(tg, torch.zeros(4), 8)
            assert _bits_of(float(ts)) == _bits_of(rs), (k, a)
            assert np.array_equal(tq.numpy(), np.asarray(rq)), (k, a)
            assert np.array_equal(tc.numpy().view(np.int32),
                                  np.asarray(rc).view(np.int32)), (k, a)
            assert np.array_equal(tfb.numpy().view(np.int32),
                                  np.asarray(rfb).view(np.int32)), (k, a)
            n += 1
    assert n == 43_811


def test_payload_bytes_and_wire_dtype():
    g = {"a": torch.zeros(1000), "b": torch.zeros(24)}
    assert G.payload_bytes(g, 7) == RG.payload_bytes(
        {"a": jnp.zeros((1000,)), "b": jnp.zeros((24,))}, 7) == 1024
    for k, n in ((2, 16), (8, 16), (12, 16), (4, 512), (1, 1), (20, 2)):
        assert str(G.sum_safe_int_dtype(k, n)).replace("torch.", "") == \
            np.dtype(RG.sum_safe_int_dtype(k, n)).name


# ------------------------------------------------------------ checkpoints --

def _ref_payload(path, step):
    with open(f"{path}/ckpt-{step}.pkl", "rb") as f:
        return pickle.load(f)


def _state_tree(params):
    """Params and an AdamW state (an int32 step leaf included)."""
    return (params, O.adamw_init(params))


@pytest.fixture(scope="module")
def saved(setup, tmp_path_factory):
    """The same trees saved by both packages: f32 params, bf16 params,
    params + AdamW state after one step, and the reduced mamba2 and olmoe
    trees in bfloat16, whose SSD leaves and router stay float32 and whose
    experts are rank-4 ``(L, E, D, F)`` leaves."""
    _, params, grads, bf16 = setup
    rstate_p = jax.tree.map(jnp.asarray, params)
    rs = RO.adamw_init(rstate_p)
    rstate_p, rs = RO.adamw_update(rstate_p, jax.tree.map(jnp.asarray,
                                                          grads[0]), rs,
                                   lr=3e-3)
    trees = {"f32": (params, _torch(params)),
             "bf16": (bf16, jax.tree.map(
                 lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                     torch.bfloat16), bf16)),
             "state": ((_np(rstate_p), _np(rs)),
                       (_torch(_np(rstate_p)), O.OptState(
                           torch.tensor(int(rs.step), dtype=torch.int32),
                           _torch(_np(rs.inner)))))}
    for name, arch in (("ssm", "mamba2-780m"), ("moe", "olmoe-1b-7b")):
        cfg = ref_configs.get_reduced(arch).replace(dtype="bfloat16",
                                                    param_dtype="bfloat16")
        tree = _params(cfg, np.random.default_rng(7))
        trees[name] = (tree, jax.tree.map(_leaf_tensor, tree))
    out = {}
    for name, (ref_tree, port_tree) in trees.items():
        rdir = tmp_path_factory.mktemp(f"ref_{name}")
        pdir = tmp_path_factory.mktemp(f"port_{name}")
        RC.save_checkpoint(str(rdir), ref_tree, step=3)
        info = C.save_checkpoint(str(pdir), port_tree, step=3, device="cpu")
        out[name] = (str(rdir), str(pdir), port_tree, info)
    return out


SAVED = ["f32", "bf16", "state", "ssm", "moe"]


@pytest.mark.parametrize("name", SAVED)
def test_checkpoint_blobs_byte_identical(saved, name):
    rdir, pdir, tree, info = saved[name]
    ref = _ref_payload(rdir, 3)
    port = C.read_payload(pdir, 3)
    assert port["step"] == ref["step"] == 3
    assert len(port["blobs"]) == len(ref["blobs"]) == len(tree_leaves(tree))
    total = 0
    for pb, rb in zip(port["blobs"], ref["blobs"]):
        lbp = rb["lbp"]
        assert pb["shape"] == tuple(rb["shape"])
        assert pb["dtype"] == rb["dtype"]
        assert (pb["count"], pb["exponent"], pb["nbits"],
                pb["plane_raw_bits"]) == (lbp.count, lbp.exponent,
                                          lbp.nbits, lbp.plane_raw_bits)
        assert pb["planes"] == lbp.planes and pb["signs"] == lbp.signs
        total += lbp.total_nbytes
    assert info == {"bytes": total, "step": 3}
    # plain data only: no class of either package in the file
    raw = open(f"{pdir}/ckpt-3.pkl", "rb").read()
    assert b"repro" not in raw.replace(C.FORMAT.encode(), b"")
    if name == "state":
        assert [b["dtype"] for b in port["blobs"]].count("int32") == 1
    dtypes = {b["path"][-1]: b["dtype"] for b in port["blobs"]}
    if name == "ssm":
        assert all(dtypes[k] == "float32"
                   for k in ("a_log", "dt_bias", "d_skip"))
    if name == "moe":
        assert dtypes["router"] == "float32" and dtypes["wg"] == "bfloat16"
        assert max(len(b["shape"]) for b in port["blobs"]) == 4


@pytest.mark.parametrize("name", SAVED)
@pytest.mark.parametrize("tau", [0.0, 1e-4, 1e-2])
def test_restore_bit_equal_to_the_reference(saved, name, tau):
    rdir, pdir, tree, _ = saved[name]
    rtree, rrep = RC.restore_checkpoint(rdir, tau_rel=tau)
    ttree, trep = C.restore_checkpoint(pdir, tau_rel=tau, device="cpu")
    assert trep.step == rrep.step == 3
    assert (trep.bytes_moved, trep.bytes_full) == (rrep.bytes_moved,
                                                   rrep.bytes_full)
    assert trep.tensor_bounds == rrep.tensor_bounds
    assert set(trep.rms_bounds) == set(rrep.rms_bounds)
    for i, b in rrep.rms_bounds.items():
        assert trep.rms_bounds[i] == pytest.approx(b, rel=1e-14, abs=0)
    rleaves = jax.tree.leaves(rtree)
    for a, b in zip(tree_leaves(ttree), rleaves):
        b = np.asarray(b)
        assert str(a.dtype).replace("torch.", "") == b.dtype.name
        a32 = a.float() if a.dtype == torch.bfloat16 else a
        b32 = b.astype(np.float32) if b.dtype.name == "bfloat16" else b
        assert np.array_equal(a32.numpy(), b32)
    for i, (a, b) in enumerate(zip(tree_leaves(ttree), tree_leaves(tree))):
        err = (a.double() - b.double().reshape(a.shape)).abs().max()
        assert float(err) <= trep.tensor_bounds[i]
        # tau 0 restores the parameters bit for bit; an optimizer moment
        # spans more than the 48 planes' 2^24 below float32's precision,
        # so its tiniest values lose bits (as in the reference)
        if tau == 0.0 and name != "state":
            assert torch.equal(a, b.reshape(a.shape))
    if tau > 0.0:
        assert trep.bytes_moved < trep.bytes_full


def test_restored_tree_keeps_the_saved_structure(saved):
    _, pdir, tree, _ = saved["state"]
    restored, _ = C.restore_checkpoint(pdir, device="cpu")
    state = tree_unflatten_like(tree, tree_leaves(restored))
    assert isinstance(state[1], O.OptState)
    assert state[1].step.dtype == torch.int32 and int(state[1].step) == 1
    assert [p for p, _ in flatten_with_paths(restored)] == \
        [p for p, _ in flatten_with_paths(tree)]
    paths = [p for p, _ in flatten_with_paths(tree)]
    rebuilt = tree_from_paths(paths, tree_leaves(tree))
    assert [p for p, _ in flatten_with_paths(rebuilt)] == paths


def test_plane_and_sign_nbytes_equal_the_reference(saved):
    """Over every leaf the three trees saved (dense, all-ones norm scales,
    bfloat16, an int32 step): the port's ``LevelBitplanes`` counts the
    reference's bytes per plane and for the signs."""
    for rdir, pdir, _, _ in saved.values():
        for pb, rb in zip(C.read_payload(pdir, 3)["blobs"],
                          _ref_payload(rdir, 3)["blobs"]):
            got, ref = C._group(pb), rb["lbp"]
            assert isinstance(got, encoder.LevelBitplanes)
            assert [got.plane_nbytes(b) for b in range(len(got.planes))] \
                == [ref.plane_nbytes(b) for b in range(len(ref.planes))]
            assert got.sign_nbytes == ref.sign_nbytes


def test_latest_step_and_async_checkpointer(setup, tmp_path):
    _, params, _, _ = setup
    assert C.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(str(tmp_path), device="cpu")
    tree = _torch(params)
    ck = C.AsyncCheckpointer(str(tmp_path), device="cpu")
    ck.save(tree, 1)
    before = tree["embed"]["table"].clone()
    # a later step cannot change the snapshot: save took a host copy
    tree["embed"]["table"].add_(1.0)
    ck.save(tree, 2)
    ck.wait()
    assert C.latest_step(str(tmp_path)) == 2
    r1, _ = C.restore_checkpoint(str(tmp_path), step=1, device="cpu")
    r2, rep = C.restore_checkpoint(str(tmp_path), device="cpu")
    assert rep.step == 2
    assert torch.equal(r1["embed"]["table"], before)
    assert torch.equal(r2["embed"]["table"], tree["embed"]["table"])
    ck.close()
    # a failed write surfaces at the next wait()
    bad = C.AsyncCheckpointer(str(tmp_path), device="cpu")
    bad.save({"w": torch.zeros(3, dtype=torch.complex64)}, 9)
    with pytest.raises(RuntimeError, match="failed") as info:
        bad.close()
    assert isinstance(info.value.__cause__, TypeError)
    assert C.latest_step(str(tmp_path)) == 2


def test_entropy_pool_gives_the_same_blobs(setup, tmp_path):
    """The stage mapped over a pool of spawned processes writes and
    restores what it does in process; the trainer's pool is made only for
    a tree of at least ``POOL_MIN_ELEMENTS``."""
    _, params, _, _ = setup
    tree = _torch(params)
    assert C.entropy_pool(C.POOL_MIN_ELEMENTS - 1) is None
    pool = C.entropy_pool(C.POOL_MIN_ELEMENTS)
    if C.default_workers() > 1:
        assert pool._max_workers == C.default_workers()
        pool.shutdown()      # made, never used: no worker was started
    else:
        assert pool is None
    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        C.save_checkpoint(str(tmp_path / "pool"), tree, 0, device="cpu",
                          executor=pool)
        a, rep_a = C.restore_checkpoint(str(tmp_path / "pool"), 1e-4,
                                        device="cpu", executor=pool)
    finally:
        pool.shutdown()
    C.save_checkpoint(str(tmp_path / "serial"), tree, 0, device="cpu")
    assert C.read_payload(str(tmp_path / "pool"), 0) == \
        C.read_payload(str(tmp_path / "serial"), 0)
    b, rep_b = C.restore_checkpoint(str(tmp_path / "serial"), 1e-4,
                                    device="cpu")
    assert rep_a == rep_b
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ------------------------------------------------------ train step, fault --

def test_train_step_three_steps_match_the_reference(setup):
    cfg, params, _, _ = setup
    ref_init, ref_step = ref_make_step(cfg, lr=1e-3)
    ref_step = jax.jit(ref_step)
    rp = jax.tree.map(jnp.asarray, params)
    ro = ref_init(rp)
    pcfg = configs.get_reduced(NAME)
    init, step = make_train_step(pcfg, lr=1e-3)
    model = params_from_arrays(params, pcfg, device="cpu")
    tp = model.tree()
    to = init(tp)
    for s in range(3):
        batch = _np(ref_batch(cfg, 2, 16, seed=s))
        rp, ro, rm = ref_step(rp, ro, batch)
        tp, to, tm = step(tp, to, {k: torch.from_numpy(np.array(v))
                                   for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_reduces_loss(setup, opt):
    _, params, _, _ = setup
    cfg = configs.get_reduced(NAME).replace(optimizer=opt)
    init, step = make_train_step(cfg, lr=3e-3)
    model = params_from_arrays(params, cfg, "cpu")
    batch = make_train_batch(cfg, 2, 16, device="cpu")
    p = model.tree()
    state = init(p)
    with torch.no_grad():
        l0 = float(model.loss(batch)[0])
    for _ in range(10):
        p, state, m = step(p, state, batch)
    assert math.isfinite(float(m["loss"])) and float(m["loss"]) < l0


def test_restart_resumes_and_matches(setup, tmp_path):
    """Injected failure at step 7: the run restarts from step 5's checkpoint
    (params + AdamW state, its int32 step included) and finishes; the final
    loss matches a failure-free run exactly (CPU determinism, bit-exact
    restore)."""
    cfg = configs.get_reduced(NAME)
    _, params, _, _ = setup
    init, step_fn = make_train_step(cfg, lr=1e-3)
    batch = make_train_batch(cfg, 2, 16, device="cpu")

    def loop(step, state):
        p, o = state
        p, o, m = step_fn(p, o, batch)
        return (p, o), m["loss"]

    def final(inject):
        p = _torch(params)
        ck = C.AsyncCheckpointer(str(tmp_path / ("f" if inject else "n")),
                                 device="cpu")
        state, log = run_with_failures(
            loop, (p, init(p)), n_steps=10, ckpt=ck,
            injector=FailureInjector(fail_at=[7] if inject else []),
            ckpt_every=5)
        ck.close()
        assert isinstance(state[1], O.OptState)
        assert state[1].step.dtype == torch.int32
        assert int(state[1].step) == 10
        return float(T_loss(cfg, state[0], batch)), log

    l_plain, log_plain = final(False)
    l_fail, log_fail = final(True)
    assert log_fail["restarts"] == 1 and log_plain["restarts"] == 0
    assert l_fail == l_plain


def T_loss(cfg, params, batch):
    from repro_torch.models.transformer import loss_fn
    with torch.no_grad():
        return loss_fn(params, cfg, batch)[0]


def test_straggler_policy_skips_slow_shards():
    def fast():
        return np.ones(4)

    def slow():
        time.sleep(0.3)
        return np.ones(4)

    pol = StragglerPolicy(deadline_s=0.15)
    out = pol.gather([fast, slow, fast])
    assert pol.skipped >= 1
    assert 1 <= len(out) < 3


# ------------------------------------------------------------------- CLI --

def test_cli_trains_checkpoints_and_resumes_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
              "--progressive-ckpt", ck,
              "--log-every", "1"]
    run = launch_train.train(common + ["--steps", "5", "--ckpt-every", "2",
                                       "--grad-compress", "8"],
                             keep_snapshots=True)
    assert sorted(run.losses) == [0, 1, 2, 3, 4] and run.saved == [0, 2, 4]
    assert all(math.isfinite(v) for v in run.losses.values())
    assert C.latest_step(ck) == 4
    out = capsys.readouterr().out
    assert "step=0 loss=" in out and "tok/s=" in out and "done: 5 steps" in out
    # resume exactly: the restored params are the step-4 snapshot
    again = launch_train.train(common + ["--steps", "7", "--resume",
                                         "--ckpt-every", "100"],
                               keep_snapshots=True)
    assert sorted(again.losses) == [5, 6] and again.restore.step == 4
    for a, b in zip(tree_leaves(again.restored),
                    tree_leaves(run.snapshots[4])):
        assert torch.equal(a, b)
    assert again.restore.bytes_moved == again.restore.bytes_full
    # a warm restart from a partial restore moves fewer bytes, within bound
    warm = launch_train.train(common + ["--steps", "6", "--resume",
                                        "--restore-tau", "1e-3",
                                        "--ckpt-every", "100"],
                              keep_snapshots=True)
    rep = warm.restore
    assert rep.bytes_moved < rep.bytes_full
    for i, (a, b) in enumerate(zip(tree_leaves(warm.restored),
                                   tree_leaves(run.snapshots[4]))):
        assert float((a.double() - b.double()).abs().max()) <= \
            rep.tensor_bounds[i]
    out = capsys.readouterr().out
    assert "[restore] step=4 moved=" in out
    assert launch_train.main(common + ["--steps", "1",
                                       "--progressive-ckpt", ""]) == 0


def test_cli_wants_cuda_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])
