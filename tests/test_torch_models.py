"""The port's models, every family (``repro_torch.models``,
``repro_torch.configs``, ``repro_torch.convert``), against the JAX package
on the same weights.

Both packages see the same parameters (seeded numpy weights in the
reference's tree, at its init's scales) and the same seeded batches.  JAX runs in x64 mode, as in
the reference's trainer (its checkpoint module turns x64 on), where the
attention scores are widened to float64; the port computes them so.

Tolerances: logits and loss rtol 1e-5, atol 1e-5 (float32 products and
reductions in another order, and XLA's own float32 ``exp``/``log``); the
other families' logits atol ``FAMILY_ATOL_FRAC`` = 1e-5 of the largest
logit (their logits reach ~10 with the SSD's recurrence amplifying
last-bit differences; measured worst 3.0e-6 of the largest, zamba2);
gradients rtol 1e-4 with atol ``GRAD_ATOL_FRAC`` = 1e-5 of the leaf's
largest gradient, for its near-zero entries (the backward sums in another
order again; the largest gap measured, over every leaf of the dense
cases, is 2.33e-6 of that leaf's largest gradient).  The other families'
gradients take ``FAMILY_GRAD_ATOL_FRAC`` (their largest gap measured is
2.6e-5 of the leaf's largest gradient, in zamba2's SSD blocks, where
XLA's float32 ``exp`` and ``log1p`` and the chunk cumsum differ from
torch's in the last bit and the decays amplify it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro._x64  # noqa: E402,F401  (the reference trainer's mode)
from repro import configs as ref_configs  # noqa: E402
from repro.data.batches import make_train_batch as ref_batch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_arrays, params_to_arrays  # noqa: E402
from repro_torch.data.batches import make_train_batch  # noqa: E402
from repro_torch.device import DTYPES  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

DENSE = ("internlm2-1.8b", "qwen2.5-14b", "glm4-9b", "gemma3-1b")
OTHER = ("mamba2-780m", "llama4-maverick-400b-a17b", "olmoe-1b-7b",
         "zamba2-2.7b", "seamless-m4t-medium", "phi-3-vision-4.2b")
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-5
FAMILY_GRAD_ATOL_FRAC = 1e-4
FAMILY_ATOL_FRAC = 1e-5


def _ref_params(cfg, seed=0):
    """Seeded numpy weights in the reference's tree (its leaves, shapes and
    dtypes, from ``jax.eval_shape`` of its init) at its init's scales:
    normal, times ``shape[-2] ** -0.5`` but 1 for the embedding table.  Norm
    scales and biases are moved off their ones and zeros, so every
    parameter matters."""
    shapes = jax.eval_shape(
        lambda: RT.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if "scale" in name:
            a = 1.0 + 0.1 * z
        elif name.endswith(("['bq']", "['bk']", "['bv']")):
            a = 0.1 * z
        else:
            a = z if "embed" in name else z * s.shape[-2] ** -0.5
        return a.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _ref_loss_and_grads(cfg, params, batch):
    def run(p, b):
        (loss, _), grads = jax.value_and_grad(
            lambda q: RT.loss_fn(q, cfg, b), has_aux=True)(p)
        return RT.forward(p, cfg, b)[0], loss, grads

    logits, loss, grads = jax.jit(run)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits), float(loss), _flat(grads)


def _port_loss_and_grads(cfg, params, batch):
    model = params_from_arrays(params, cfg, device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    logits, _ = model(tb)
    loss, _, grads = value_and_grad(cfg, model.tree(), tb)
    from repro_torch.train.pytree import tree_leaves
    return (logits.detach().numpy(), float(loss),
            [g.numpy() for g in tree_leaves(grads)])


# seq 600 pads the queries to two chunks of 512: causal (internlm2), the
# encoder's and the cross attention's unmasked (seamless), and the vlm's 8
# patches + 600 tokens
CASES = [(name, 32) for name in DENSE + OTHER] + [
    ("internlm2-1.8b", 600), ("seamless-m4t-medium", 600),
    ("phi-3-vision-4.2b", 600)]


@pytest.fixture(scope="module")
def runs():
    """Reference and port logits, loss and grads per (arch, seq), B = 2."""
    out = {}
    for name, seq in CASES:
        cfg = ref_configs.get_reduced(name)
        params = _ref_params(cfg)
        batch = jax.tree.map(np.asarray, ref_batch(cfg, 2, seq, seed=3))
        out[name, seq] = (_ref_loss_and_grads(cfg, params, batch),
                          _port_loss_and_grads(configs.get_reduced(name),
                                               params, batch))
    return out


@pytest.mark.parametrize("name,seq", CASES)
def test_forward_and_loss_match_the_reference(runs, name, seq):
    (ref_logits, ref_loss, _), (logits, loss, _) = runs[name, seq]
    assert logits.shape == ref_logits.shape == (2, seq,
                                                 ref_configs.get_reduced(
                                                     name).vocab)
    atol = ATOL if name in DENSE else \
        FAMILY_ATOL_FRAC * float(np.abs(ref_logits).max())
    np.testing.assert_allclose(logits, ref_logits, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(loss, ref_loss, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,seq", CASES)
def test_grads_match_jax_grad(runs, name, seq):
    (_, _, ref_grads), (_, _, grads) = runs[name, seq]
    assert len(grads) == len(ref_grads)
    frac = GRAD_ATOL_FRAC if name in DENSE else FAMILY_GRAD_ATOL_FRAC
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(
            g, r, rtol=GRAD_RTOL, atol=frac * float(np.abs(r).max()))


def test_chunked_attention_runs_two_chunks_at_600():
    """S = 600 > QUERY_CHUNK pads the queries to two chunks; each chunk
    equals unchunked attention over its rows."""
    assert L.QUERY_CHUNK == RL.QUERY_CHUNK == 512
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 600, 4, 16)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    pos = np.arange(600, dtype=np.int32)
    for local in (False, True):
        ref = np.asarray(RL.gqa_attend_chunked(
            *(jnp.asarray(a) for a in (q, k, v, pos, pos)),
            jnp.asarray(local), 8))
        got = L.gqa_attend_chunked(
            *(torch.from_numpy(a) for a in (q, k, v, pos, pos)), local, 8)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
        whole = L.gqa_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                             L.gqa_scores_mask(torch.from_numpy(pos),
                                               torch.from_numpy(pos),
                                               local, 8))
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_rope_frequencies_and_layer_flags_equal_the_reference():
    for name in DENSE:
        cfg = ref_configs.get_reduced(name)
        ref = np.asarray(RL.rope_frequencies(cfg))
        got = L.rope_frequencies(configs.get_reduced(name)).numpy()
        assert got.dtype == ref.dtype and np.array_equal(
            got.view(np.int32), ref.view(np.int32)), name
        ref_flags = RT.layer_flags(cfg)
        for k, v in T.layer_flags(configs.get_reduced(name)).items():
            assert np.array_equal(v, np.asarray(ref_flags[k])), (name, k)
    # glm4's partial rotary (0.5 of 16) rotates 8 of each head's 16 dims
    assert L.rope_frequencies(configs.get_reduced("glm4-9b")).shape == (4,)


def test_converter_round_trip_f32_and_bf16():
    for cfg_name, dtype in (("internlm2-1.8b", "float32"),
                            ("gemma3-1b", "bfloat16")):
        cfg = ref_configs.get_reduced(cfg_name).replace(
            dtype=dtype, param_dtype=dtype)
        params = _ref_params(cfg)
        model = params_from_arrays(params, configs.get_reduced(
            cfg_name).replace(dtype=dtype, param_dtype=dtype), device="cpu")
        names = [n for n, _ in model.leaves()]
        ref_names = [".".join(str(k.key) for k in path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(params)[0]]
        assert names == ref_names
        back = params_to_arrays(model)
        for a, b in zip(_flat(back), _flat(params)):
            assert a.shape == b.shape
            assert np.array_equal(a, np.asarray(b, np.float32)), cfg_name
        for (_, p), b in zip(model.leaves(), _flat(params)):
            assert p.dtype == DTYPES[dtype]
        again = params_from_arrays(back, model.cfg, device="cpu")
        for (_, a), (_, b) in zip(again.leaves(), model.leaves()):
            assert torch.equal(a, b)


def test_parameters_are_one_stacked_leaf_each():
    cfg = configs.get_reduced("glm4-9b")
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    named = dict(model.named_parameters())
    assert named["params.layers.attn.wq"].shape == (2, 64, 64)
    assert named["params.layers.attn.bq"].shape == (2, 64)
    assert named["params.layers.mlp.wg"].shape == (2, 64, 128)
    ref = jax.eval_shape(lambda: RT.init_params(
        jax.random.PRNGKey(0), ref_configs.get_reduced("glm4-9b")))
    assert [tuple(s.shape) for s in jax.tree.leaves(ref)] == \
        [tuple(p.shape) for _, p in model.leaves()]
    # the reference's distributions: ones for norms, zeros for biases
    tree = model.tree()
    assert torch.equal(tree["layers"]["norm1"]["scale"],
                       torch.ones(2, 64))
    assert torch.equal(tree["layers"]["attn"]["bk"], torch.zeros(2, 32))
    wq = tree["layers"]["attn"]["wq"].detach()
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.01


def test_remat_gives_the_same_grads():
    cfg = configs.get_reduced("gemma3-1b")
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = make_train_batch(cfg, 2, 24, seed=1, device="cpu")
    out = [value_and_grad(cfg.replace(remat=remat), params, batch)
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    from repro_torch.train.pytree import tree_leaves
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


# leaves the reference's init sets without its random key: norm scales,
# biases, the SSD's conv bias, a_log, dt_bias and d_skip
DETERMINISTIC = ("scale", "bq", "bk", "bv", "conv_b", "a_log", "dt_bias",
                 "d_skip")


@pytest.mark.parametrize("name", OTHER)
def test_other_families_raise_naming_a12(name):
    """These families raised ``NotImplementedError`` naming A12's later
    slice; each now builds.  The port's init gives the reference's tree:
    the same paths in the same leaf order, shapes and dtypes (float32
    router and SSD leaves in a bfloat16 model), and the leaves the
    reference sets without its key equal bit for bit."""
    for cfg, rcfg in ((configs.get_reduced(name),
                       ref_configs.get_reduced(name)),
                      (configs.get_reduced(name).replace(
                          dtype="bfloat16", param_dtype="bfloat16"),
                       ref_configs.get_reduced(name).replace(
                           dtype="bfloat16", param_dtype="bfloat16"))):
        model = T.Transformer(cfg, generator=torch.Generator().manual_seed(3),
                              device="cpu")
        ref = jax.tree_util.tree_flatten_with_path(
            RT.init_params(jax.random.PRNGKey(0), rcfg))[0]
        got = list(model.leaves())
        assert [n for n, _ in got] == [
            ".".join(str(k.key) for k in path) for path, _ in ref]
        for (path, r), (n, p) in zip(ref, got):
            r = np.asarray(r)
            assert tuple(p.shape) == r.shape, n
            assert str(p.dtype).replace("torch.", "") == r.dtype.name, n
            if n.split(".")[-1] in DETERMINISTIC:
                assert np.array_equal(p.detach().float().numpy(),
                                      r.astype(np.float32)), n


def test_registry_equals_the_reference():
    assert configs.names() == ref_configs.names()
    for name in configs.names():
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(ref_configs.get(name))
        assert dataclasses.asdict(configs.get_reduced(name)) == \
            dataclasses.asdict(ref_configs.get_reduced(name))
    assert set(configs.all_configs()) == set(ref_configs.all_configs())
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("nope")


def test_make_train_batch_equals_the_reference():
    for name in ("internlm2-1.8b", "seamless-m4t-medium",
                 "phi-3-vision-4.2b"):
        cfg = configs.get_reduced(name)
        got = make_train_batch(cfg, 3, 17, seed=4, device="cpu")
        ref = ref_batch(ref_configs.get_reduced(name), 3, 17, seed=4)
        assert set(got) == set(ref)
        for k in ref:
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert got["labels"].dtype == torch.int32
        assert int(got["labels"][0, -1]) == -1
