"""The port's launch tools that need no process group
(``repro_torch.data.batches.train_input_specs`` / ``decode_token_spec``,
``launch.analytic``, ``launch.hlo_analysis``) against the JAX package.

What each comparison holds:

* input specs: the keys, shapes and dtypes of ``train_input_specs`` and
  ``decode_token_spec`` equal the reference's ``ShapeDtypeStruct``s for all
  ten configs × ``SHAPES``, on the ``meta`` device (no storage);
* ``analytic``: ``param_counts`` equal to the reference's for all ten
  configs at full width, and ``model_flops``, ``attention_flops`` and every
  entry of ``hbm_bytes`` equal as floats for every config × shape ×
  ``n_devices`` in {1, 16, 256, 512} (the decode cache counted once, as the
  reference counts it);
* the analyser against ``analyze_hlo`` on the compiled counterparts of
  ``tests/test_hlo_analysis.py``'s programs: a matmul (FLOPs, output
  bytes and dots equal), a 12-step layer loop and a 4 × 3 nested loop
  (FLOPs equal; the eager step runs each layer's product, so it counts 12
  dots where the HLO loop body holds one, and its output bytes have no
  loop counter or dynamic slice);
* the dry run counts what a real step does: a reduced config's train step
  on CPU tensors and the same step traced on fake tensors give the same
  dot FLOPs, dots, output bytes, ops and peak bytes, for every config, and
  the real step reads nothing back to the host.  (The psum, the sharded
  matmul and the dry run itself need a process group:
  ``tests/test_torch_dryrun.py``.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import batches as RB  # noqa: E402
from repro.launch import analytic as RA  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.config import SHAPES as REF_SHAPES  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import batches as B  # noqa: E402
from repro_torch.data.batches import make_train_batch  # noqa: E402
from repro_torch.launch import analytic as A  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze, shape_str  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCHS = configs.names()
N_DEVICES = (1, 16, 256, 512)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ----------------------------------------------------------- input specs --

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    assert list(SHAPES) == list(REF_SHAPES)
    for name in SHAPES:
        got = B.train_input_specs(cfg, SHAPES[name])
        want = RB.train_input_specs(ref_cfg, REF_SHAPES[name])
        assert list(got) == list(want)
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert _dtype_name(got[k].dtype) == jnp.dtype(spec.dtype).name
            assert got[k].device.type == "meta"
        tok = B.decode_token_spec(cfg, SHAPES[name])
        ref_tok = RB.decode_token_spec(ref_cfg, REF_SHAPES[name])
        assert tuple(tok.shape) == tuple(ref_tok.shape)
        assert _dtype_name(tok.dtype) == jnp.dtype(ref_tok.dtype).name
        assert tok.device.type == "meta"


# -------------------------------------------------------------- analytic --

@pytest.fixture
def ref_counts_cached(monkeypatch):
    """The reference's ``param_counts`` memoised per config for this test
    (it runs ``jax.eval_shape`` at each call; the values are unchanged)."""
    cache = {}
    orig = RA.param_counts

    def cached(cfg):
        if cfg not in cache:
            cache[cfg] = orig(cfg)
        return cache[cfg]

    monkeypatch.setattr(RA, "param_counts", cached)
    return cached


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch, ref_counts_cached):
    assert A.param_counts(configs.get(arch)) == \
        ref_counts_cached(ref_configs.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_equals_reference(arch, ref_counts_cached):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    for name in SHAPES:
        shape, ref_shape = SHAPES[name], REF_SHAPES[name]
        assert A.model_flops(cfg, shape) == RA.model_flops(ref_cfg, ref_shape)
        assert A.attention_flops(cfg, shape) == \
            RA.attention_flops(ref_cfg, ref_shape)
        for n in N_DEVICES:
            got = A.hbm_bytes(cfg, shape, n)
            want = RA.hbm_bytes(ref_cfg, ref_shape, n)
            assert got == want, (name, n)
            assert all(isinstance(v, float) for v in got.values())


def test_decode_cache_counted_once_as_the_reference():
    """internlm2-1.8b at 16 × 32,768 on one device: the reference's cache
    term is n_attn·B·T·kv·hd·2 bytes, one cache's bytes where K and V are
    two (kept for parity)."""
    cfg = configs.get("internlm2-1.8b")
    shape = SHAPES["decode_32k"].__class__("d", "decode", 32_768, 16)
    out = A.hbm_bytes(cfg, shape, 1)
    one_cache = cfg.n_layers * 16 * 32_768 * cfg.n_kv_heads * cfg.hd * 2
    assert out["kv_cache"] == one_cache == 25_769_803_776
    assert out["total"] == 29_548_023_808


# -------------------------------------------------------------- analyser --

def _hlo(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_shape_str():
    assert shape_str(torch.empty(8, 128, dtype=torch.bfloat16)) == \
        "bf16[8,128]"
    assert shape_str(torch.empty(16)) == "f32[16]"
    assert shape_str(torch.empty((), dtype=torch.int32)) == "s32[]"


def test_matmul_counts_equal_analyze_hlo():
    want = analyze_hlo(_hlo(lambda x, y: x @ y, _f32(128, 256), _f32(256, 64)))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    _, got = analyze(lambda x, y: x @ y, a, b)
    assert got.flops == want.flops == 2 * 128 * 256 * 64
    assert got.n_dots == want.n_dots == 1
    assert got.memory_bytes == want.memory_bytes == 128 * 64 * 4
    assert got.collective_bytes == want.collective_bytes == 0


def test_layer_loop_flops_equal_analyze_hlo():
    def ref(x, ws):
        def body(h, wi):
            return h @ wi, None
        return jax.lax.scan(body, x, ws)[0]

    want = analyze_hlo(_hlo(ref, _f32(64, 64), _f32(12, 64, 64)))
    x, ws = torch.ones(64, 64), torch.ones(12, 64, 64)

    def port(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x

    _, got = analyze(port, x, ws)
    assert got.flops == want.flops == 12 * 2 * 64 ** 3
    assert (got.n_dots, want.n_dots) == (12, 1)
    assert got.memory_bytes == 12 * 64 * 64 * 4


def test_nested_loops_flops_equal_analyze_hlo():
    def ref(x, ws):
        def outer(h, wrow):
            def inner(hh, wi):
                return hh @ wi, None
            return jax.lax.scan(inner, h, wrow)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    want = analyze_hlo(_hlo(ref, _f32(32, 32), _f32(4, 3, 32, 32)))

    def port(x, ws):
        for row in ws.unbind(0):
            for w in row.unbind(0):
                x = x @ w
        return x

    _, got = analyze(port, torch.ones(32, 32), torch.ones(4, 3, 32, 32))
    assert got.flops == want.flops == 12 * 2 * 32 ** 3
    assert got.n_dots == 12


def test_bookkeeping_is_not_memory():
    """Views, copies, clones and allocations are bookkeeping; a cast and a
    compute op count their output bytes."""
    x = torch.ones(4, 8)

    def f(x):
        y = x.reshape(8, 4).t().contiguous().clone()
        z = torch.zeros(4, 8)
        return (y + z).to(torch.float64)

    _, st = analyze(f, x)
    assert st.memory_bytes == 4 * 8 * 4 + 4 * 8 * 8
    assert st.flops == 0 and st.n_dots == 0


def _step_stats(arch, fake):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_reduced(arch)
    opt_init, step = make_train_step(cfg)
    batch = make_train_batch(cfg, 2, 16, device="cpu")
    if not fake:
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return analyze(step, params, opt_init(params), batch)[1]
    with FakeTensorMode():
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in batch.items()}
        return analyze(step, params, opt_init(params), fake_batch)[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_trace_counts_what_a_real_step_does(arch):
    real, fake = _step_stats(arch, False), _step_stats(arch, True)
    assert real.flops > 0
    for key in ("flops", "n_dots", "memory_bytes", "n_ops", "peak_bytes"):
        assert getattr(real, key) == getattr(fake, key), key
    assert [r.shape for r in real.records if r.flops] == \
        [r.shape for r in fake.records if r.flops]
    assert not any(r.op == "aten._local_scalar_dense" for r in real.records)
