"""The split-KV decode attention's plain version and its routing, on the CPU.

``kernels.decode_attn.decode_attn_plain`` repeats the CUDA kernel's
arithmetic (splits of the cache's slots, float32 dot products, float64
softmax, float32 P·V, a float64 merge of the splits); here it is held to
``layers._gqa_attend`` with the decode mask, the path the kernel replaces,
at reduced sizes: group sizes 1, 2 and 4, head sizes 64 and 128, several
split counts, ``pos`` at and around split edges and past the cache's end,
splits that lie wholly past the valid slots, and local layers (an empty
window included).  In float32 both compute the same function up to the
order of float32 sums; in bfloat16 the plain version's error against a
float64 evaluation is no larger than ``_gqa_attend``'s.  The same cases
hold it to the JAX package: ``jax.jit`` of ``repro.models.layers.gqa_attend``
under ``repro``'s ``gqa_scores_mask``, on the same float32 inputs (and in
bfloat16 on the same bfloat16 ones), float64 enabled as in the reference's
trainer.  ``fixtures/decode_attn_jax.npz`` (``_decode_attn_fixture.py``)
is the JAX package's output at the olmoe-decode-4k cell's row shape, which
the card test holds the kernel to; here it is held to a fresh JAX run and
to the plain version.

The predicate ``admits`` sends CPU tensors, int8 caches, DTensor caches
and head shapes the library has no instance for to the plain path; its
instances are those of ``csrc/decode_attn.cu`` and of every full-size
configuration that decodes through ``attention_decode``.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _decode_attn_fixture as FIX  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _inputs(b, t, kv, g, hd, seed, dtype=torch.float32, key_scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, kv * g, hd), generator=gen)
    k = torch.randn((b, t, kv, hd), generator=gen) * key_scale
    v = torch.randn((b, t, kv, hd), generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _plain_path(q, k, v, pos, window):
    t = k.shape[1]
    mask = L.gqa_scores_mask(torch.tensor([pos], dtype=torch.int32),
                             torch.arange(t, dtype=torch.int32), window > 0,
                             window)
    return L._gqa_attend(q, k, v, mask)


def _float64(q, k, v, pos, window):
    """The same attention evaluated in float64 from the inputs' values."""
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    lo, hi, uniform = DA.window_bounds(pos, t, window)
    qd = q.double().reshape(b, kv, h // kv, hd)
    s = torch.einsum("bkgd,bnkd->bkgn", qd, k[:, lo:hi].double())
    s = torch.zeros_like(s) if uniform else s / float(np.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgn,bnkd->bkgd", p, v[:, lo:hi].double())
    return out.reshape(b, 1, h, hd)


# (T, n_split, pos, window): with T 200 and 4 splits of 50 slots, pos at a
# split's last slot, its first and one past; pos in the first split (three
# splits wholly past the valid slots); pos past the cache's end (the
# clamped slot); local windows around the edges, and one left empty
EDGES = (
    (200, 4, 49, 0), (200, 4, 50, 0), (200, 4, 51, 0), (200, 4, 99, 0),
    (200, 4, 0, 0), (200, 4, 7, 0), (200, 4, 199, 0), (200, 4, 200, 0),
    (200, 4, 517, 0), (200, 1, 120, 0), (200, 7, 120, 0), (200, 13, 150, 0),
    (200, 4, 120, 16), (200, 4, 60, 11), (200, 4, 199, 50), (200, 4, 240, 50),
    (200, 4, 248, 50), (200, 4, 600, 50), (200, 4, 49, 1),
)


@pytest.mark.parametrize("g", (1, 2, 4))
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("edge", EDGES, ids=lambda e: "t%d-s%d-p%d-w%d" % e)
def test_plain_split_version_equals_the_plain_path(g, hd, edge):
    """float32: the split-KV arithmetic against ``_gqa_attend`` with the
    decode mask, within 2e-6 of the output's largest magnitude (the two
    differ in the order of float32 sums and in the float64 merge)."""
    t, n_split, pos, window = edge
    q, k, v = _inputs(2, t, 2, g, hd, seed=hd + g + pos)
    want = _plain_path(q, k, v, pos, window)
    got = DA.decode_attn_plain(q, k, v, pos, window > 0, window, n_split)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * float(want.abs().max()))
    jax_out = FIX.jax_attend(q, k, v, pos, window, "float32")
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0,
                               atol=2e-6 * float(np.abs(jax_out).max()))


@pytest.mark.parametrize("g", (1, 2, 4))
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("pos,window", ((383, 0), (100, 0), (500, 0),
                                        (300, 64)))
def test_plain_split_version_no_less_precise_in_bfloat16(g, hd, pos, window):
    """bfloat16 inputs, keys at 3× scale: against a float64 evaluation the
    split-KV arithmetic's largest error is no larger than the plain path's
    or the JAX package's (both round the scores and the probabilities to
    bfloat16), and it is within one bfloat16 rounding of the JAX package's
    attention of the same values in float32."""
    q, k, v = _inputs(2, 384, 2, g, hd, seed=pos + g, dtype=torch.bfloat16,
                      key_scale=3.0)
    want = _float64(q, k, v, pos, window)
    got = DA.decode_attn_plain(q, k, v, pos, window > 0, window)
    plain = _plain_path(q, k, v, pos, window)
    assert got.dtype == torch.bfloat16
    err = float((got.double() - want).abs().max())
    assert err <= float((plain.double() - want).abs().max())
    # one rounding to bfloat16 of a nearly exact result
    assert bool(((got.double() - want).abs()
                 <= want.abs() * 2.0 ** -8 + 1e-6).all())
    jax_bf16 = torch.from_numpy(FIX.jax_attend(q, k, v, pos, window,
                                               "bfloat16")).double()
    assert err <= float((jax_bf16 - want).abs().max())
    jax_f32 = torch.from_numpy(FIX.jax_attend(q, k, v, pos, window,
                                              "float32")).double()
    assert bool(((got.double() - jax_f32).abs()
                 <= jax_f32.abs() * 2.0 ** -8 + 1e-6).all())


def test_split_counts_do_not_change_the_result():
    q, k, v = _inputs(3, 300, 2, 2, 64, seed=9)
    one = DA.decode_attn_plain(q, k, v, 250, False, 0, 1)
    for n in (2, 3, 5, 8, 300):
        got = DA.decode_attn_plain(q, k, v, 250, False, 0, n)
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                                   atol=2e-6 * float(one.abs().max()))


@pytest.mark.parametrize("bk,t,want", (
    (128, 32768, (32, 1024)),       # internlm2-decode-32k: B 16 × K 8
    (1024, 4096, (4, 1024)),        # olmoe-decode-4k: B 64 × K 16
    (8, 32768, (512, 64)),
    (4096, 8192, (1, 8192)),
    (2, 100, (2, 64)),
    (3, 1, (1, 64)),
))
def test_split_plan(bk, t, want):
    n_split, chunk = DA.split_plan(bk, t)
    assert (n_split, chunk) == want
    assert chunk % DA.SPLIT_ALIGN == 0
    assert (n_split - 1) * chunk < t <= n_split * chunk


@pytest.mark.parametrize("pos,t,window,want", (
    (0, 10, 0, (0, 1, False)),
    (9, 10, 0, (0, 10, False)),
    (15, 10, 0, (0, 10, False)),
    (5, 10, 3, (3, 6, False)),
    (1, 10, 3, (0, 2, False)),
    (11, 10, 3, (9, 10, False)),
    (12, 10, 3, (0, 10, True)),
))
def test_window_bounds_follow_the_decode_mask(pos, t, window, want):
    assert DA.window_bounds(pos, t, window) == want
    mask = L.gqa_scores_mask(torch.tensor([pos]), torch.arange(t),
                             window > 0, window)[0]
    lo, hi, uniform = want
    if uniform:
        assert not bool(mask.any())
    else:
        assert mask.nonzero().flatten().tolist() == list(range(lo, hi))


def test_admits_no_cpu_tensor_and_the_kernel_raises_on_one():
    q, k, v = _inputs(2, 64, 8, 2, 128, seed=1, dtype=torch.bfloat16)
    assert not DA.admits(q, k, v)
    assert not DA.admits(q, k.to(torch.int8), v.to(torch.int8))
    q16, k16, v16 = _inputs(2, 64, 2, 2, 16, seed=1)
    assert not DA.admits(q16, k16, v16)
    before = DA.decode_attn.launches
    with pytest.raises(ValueError, match="no kernel"):
        DA.decode_attn(q, k, v, torch.tensor(3, dtype=torch.int32), False, 0)
    assert DA.decode_attn.launches == before


def test_admits_no_dtensor_cache(tmp_path):
    """A DTensor cache (one gloo rank in this process, destroyed after)
    keeps the plain path."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    tdist.init_process_group("gloo", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        q, k, v = _inputs(2, 64, 8, 2, 128, seed=2, dtype=torch.bfloat16)
        kd = distribute_tensor(k, mesh, [Replicate()])
        vd = distribute_tensor(v, mesh, [Replicate()])
        assert not DA.admits(q, kd, vd)
    finally:
        tdist.destroy_process_group()


def test_instances_match_the_source_and_the_registry():
    """``INSTANCES`` lists exactly the source's instances, and every
    full-size configuration that decodes through ``attention_decode``
    (dense, moe, vlm, the hybrid's shared block, encdec's decoder) has
    its (cache dtype, hd, group) among them."""
    src = (build.CSRC / "decode_attn.cu").read_text()
    codes = {"__nv_bfloat16": torch.bfloat16}
    listed = {(codes[e], int(hd), int(g)) for e, hd, g in re.findall(
        r"^\s*X\((\w+), \d, (\d+), (\d+)\)", src, re.M)}
    assert listed == DA.INSTANCES
    assert "decode_attn" in build.SIGNATURES
    seen = set()
    for name in configs.names():
        cfg = configs.get(name)
        if cfg.family == "ssm":
            continue
        dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else \
            getattr(torch, cfg.dtype)
        key = (dtype, cfg.hd, cfg.n_heads // cfg.n_kv_heads)
        assert key in DA.INSTANCES, (name, key)
        seen.add(key)
    assert seen == DA.INSTANCES


@pytest.mark.parametrize("name", ("internlm2-1.8b", "gemma3-1b"))
def test_cpu_decode_keeps_the_plain_path(name):
    """A reduced config decoding on the CPU never calls the kernel."""
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import make_serve_step
    cfg = configs.get_reduced(name)
    params = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu").tree()
    state = T.init_decode_state(cfg, 2, 16, device="cpu")
    step = make_serve_step(cfg)
    before = DA.decode_attn.launches
    for _ in range(3):
        logits, state = step(params, state,
                             torch.zeros((2, 1), dtype=torch.int32))
    assert DA.decode_attn.launches == before
    assert bool(torch.isfinite(logits).all())


def test_the_fixture_is_the_jax_package_s_output():
    """``fixtures/decode_attn_jax.npz`` is what ``jax.jit`` of the
    reference's ``gqa_attend`` gives on the fixture's inputs, in bfloat16
    and in float32."""
    want = np.load(FIX.PATH)
    assert (int(want["pos"]), int(want["seed"])) == (FIX.POS, FIX.SEED)
    got = FIX.outputs(*FIX.inputs())
    for dtype, out in got.items():
        np.testing.assert_allclose(out, want[dtype], rtol=0,
                                   atol=1e-6 * float(np.abs(out).max()))


def test_plain_split_version_against_the_jax_fixture():
    """At the olmoe-decode-4k cell's row shape, with the kernel's own split
    plan: the plain split version within one bfloat16 rounding of the JAX
    package's float32 attention, and no farther from it than the JAX
    package's own bfloat16 path."""
    q, k, v = FIX.inputs()
    fix = np.load(FIX.PATH)
    want = torch.from_numpy(fix["float32"]).double()
    got = DA.decode_attn_plain(q, k, v, FIX.POS, False, 0).double()
    jax_bf16 = torch.from_numpy(fix["bfloat16"]).double()
    err = float((got - want).abs().max())
    assert err <= float((jax_bf16 - want).abs().max())
    assert bool(((got - want).abs() <= want.abs() * 2.0 ** -8 + 1e-6).all())
