"""The port's moe, ssm, hybrid, encdec and vlm pieces
(``repro_torch.models.moe``, ``ssm``, ``transformer``, ``layers``) against
the JAX package, piece by piece, in x64 mode as the reference's trainer
runs.

What each comparison holds, and to what:

* the SSD's ``a_log`` tables: bit for bit the reference's eager init;
* ``softplus`` against ``jax.nn.softplus`` (``logaddexp(x, 0)``) from -100
  to 100: bit for bit above 20, where ``F.softplus`` would turn into the
  identity; elsewhere within ``SOFTPLUS_ULPS`` float32 ulps (XLA's
  float32 ``exp`` and ``log1p`` against torch's: measured 2 ulps, on 899
  of 20,009 points), except where the result is subnormal (below x =
  -87.3): XLA's CPU runtime flushes it to 0, torch keeps it (under
  1.2e-38); its derivative within ``SOFTPLUS_GRAD_RTOL`` (and by 1.2e-38
  where it is subnormal);
* ``_ssd_chunked`` with and without ``init_state``: within ``SSD_RTOL``
  of the reference's (its chunk cumsum and XLA's float32 ``exp`` are each
  an ulp off torch's on some entries), and within 1e-4 of the naive
  recurrence, as the reference's own test holds it;
* each MoE dispatch (scatter, onehot, sort), on a seeded router, on a tied
  router (all probabilities equal) and on one that sends every token to one
  expert, so that capacity drops tokens: the routing (``gate_idx`` and the
  kept slots) equal, outputs and aux loss within ``MOE_RTOL`` (the sort
  dispatch's scatter-add sums a token's contributions in another order;
  measured far below), and the gradients through ``jax.grad`` within
  ``MOE_GRAD_RTOL`` of each leaf's largest, but the router's at top-1
  within ``ROUTER_TOP1_ATOL_FRAC``: its path through ``v / sum(v)`` with
  one term has a derivative that cancels to 0, and both packages leave
  float32 noise there (measured against a float64 evaluation: the
  reference 1.2e-4 of the leaf's largest gradient off, the port 6.7e-5);
* a hybrid with a remainder group (5 layers, period 2: two shared-block
  applications, then one Mamba2 layer): logits, loss and ``jax.grad``
  (the shared block's gradient summed over its applications) with
  ``test_torch_models``' family tolerances;
* remat: the same loss and gradients as without, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro._x64  # noqa: E402,F401  (the reference trainer's mode)
from repro import configs as ref_configs  # noqa: E402
from repro.data.batches import make_train_batch as ref_batch  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.batches import make_train_batch  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.pytree import tree_leaves  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

from test_torch_models import (FAMILY_ATOL_FRAC,  # noqa: E402
                               FAMILY_GRAD_ATOL_FRAC, GRAD_RTOL, RTOL,
                               _port_loss_and_grads, _ref_loss_and_grads,
                               _ref_params)

SOFTPLUS_ULPS = 2
SOFTPLUS_GRAD_RTOL = 1e-6
SSD_RTOL = 1e-5
MOE_RTOL = 1e-6
MOE_GRAD_RTOL = 1e-5
ROUTER_TOP1_ATOL_FRAC = 3e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ SSD --

@pytest.mark.parametrize("h", [8, 48, 80])
def test_a_log_tables_equal_the_reference(h):
    """The head counts of mamba2 (48), zamba2 (80) and their reduced
    configs (8)."""
    assert {configs.get("mamba2-780m").ssm_heads,
            configs.get("zamba2-2.7b").ssm_heads,
            configs.get_reduced("mamba2-780m").ssm_heads,
            configs.get_reduced("zamba2-2.7b").ssm_heads} == {8, 48, 80}
    ref = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h, dtype=jnp.float32)))
    got = S._a_log(h, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_softplus_equals_jax_above_twenty_and_below_zero():
    x = np.concatenate([np.linspace(-100, 100, 20001),
                        [-1e4, -88.5, -30.0, 19.99, 20.0, 20.01, 25.0, 1e4]]
                       ).astype(np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    got = S.softplus(tx)
    out = got.detach().numpy()
    sub = out < np.finfo(np.float32).tiny
    assert (x[sub] < -87.3).all() and (ref[sub] == 0).all()
    above = x > 20
    assert np.array_equal(out[above].view(np.int32),
                          ref[above].view(np.int32))
    ulps = np.abs(out[~sub].view(np.int32).astype(np.int64)
                  - ref[~sub].view(np.int32))
    assert ulps.max() <= SOFTPLUS_ULPS
    rgrad = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(
        jnp.asarray(x)))
    (g,) = torch.autograd.grad(got.sum(), tx)
    # atol: the derivative is subnormal where the value is (flushed by XLA)
    np.testing.assert_allclose(g.numpy(), rgrad, rtol=SOFTPLUS_GRAD_RTOL,
                               atol=np.finfo(np.float32).tiny)


def _ssd_inputs(seed=0, b=2, s=32, h=4, p=16, n=16, g=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32),
            rng.uniform(0.1, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, h, n, p)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_the_reference(with_state, groups):
    cfg = configs.get_reduced("mamba2-780m").replace(ssm_chunk=8)
    rcfg = ref_configs.get_reduced("mamba2-780m").replace(ssm_chunk=8)
    xh, dt, a, bm, cm, s0 = _ssd_inputs(g=groups)
    init = s0 if with_state else None
    ry, rfinal = RS._ssd_chunked(
        rcfg, *(jnp.asarray(v) for v in (xh, dt, a, bm, cm)),
        init_state=None if init is None else jnp.asarray(init))
    y, final = S._ssd_chunked(cfg, *(_t(v) for v in (xh, dt, a, bm, cm)),
                              init_state=None if init is None else _t(init))
    for got, ref in ((y, ry), (final, rfinal)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=SSD_RTOL,
                                   atol=SSD_RTOL * np.abs(ref).max())


def test_ssd_chunked_equals_naive_recurrence():
    """As ``tests/test_models_smoke.py`` holds the reference: the chunked
    form against the token-by-token recurrence, from a nonzero state."""
    cfg = configs.get_reduced("mamba2-780m").replace(ssm_chunk=8)
    xh, dt, a, bm, cm, s0 = _ssd_inputs(seed=1)
    b, s, h, p = xh.shape
    g = bm.shape[2]
    y, final = S._ssd_chunked(cfg, *(_t(v) for v in (xh, dt, a, bm, cm)),
                              init_state=_t(s0))
    hstate = s0.astype(np.float64)
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        dec = np.exp(-dt[:, t] * a[None, :])
        bh = np.repeat(bm[:, t], h // g, axis=1)
        ch = np.repeat(cm[:, t], h // g, axis=1)
        hstate = hstate * dec[..., None, None] \
            + dt[:, t, :, None, None] * bh[..., None] * xh[:, t, :, None, :]
        ys[:, t] = np.einsum("bhn,bhnp->bhp", ch, hstate)
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), hstate, atol=1e-4)


def test_ssd_chunked_asserts_whole_chunks():
    cfg = configs.get_reduced("mamba2-780m").replace(ssm_chunk=8)
    xh, dt, a, bm, cm, _ = _ssd_inputs(s=12)
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        S._ssd_chunked(cfg, *(_t(v) for v in (xh, dt, a, bm, cm)))


def test_attention_free_config_has_an_empty_rope_table():
    cfg = configs.get("mamba2-780m")
    assert cfg.n_heads == 0 and cfg.hd == 1
    from repro_torch.models import layers as L
    assert L.rope_frequencies(cfg).shape == (0,)


# ------------------------------------------------------------------ MoE --

def _moe_case(name, router, seed=2, n=(2, 16)):
    """A reduced MoE config, the reference's seeded expert weights, a router
    of the given kind, and seeded tokens."""
    rcfg = ref_configs.get_reduced(name)
    p = jax.tree.map(np.asarray, RM.init_moe(jax.random.PRNGKey(1), rcfg))
    d, e = rcfg.d_model, rcfg.n_experts
    if router == "tied":            # every probability equal
        p["router"] = np.zeros((d, e), np.float32)
    elif router == "one_expert":    # expert 3 first, the rest tied
        p["router"] = np.zeros((d, e), np.float32)
        p["router"][:, 3] = 1.0
    x = np.random.default_rng(seed).standard_normal(
        n + (d,)).astype(np.float32)
    if router == "one_expert":
        x = np.abs(x)               # positive: expert 3's logit the largest
    return rcfg, configs.get_reduced(name), p, x


def _ref_moe(rcfg, p, x, dispatch):
    def run(p, x):
        out, aux = RM.moe_block(p, rcfg, x, dispatch=dispatch)
        return jnp.sum(out * jnp.cos(out)) + aux, (out, aux)
    (_, (out, aux)), grads = jax.value_and_grad(run, argnums=(0, 1),
                                                has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(out), float(aux), grads


def _port_moe(cfg, p, x, dispatch):
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    out, aux = M.moe_block(tp, cfg, tx, dispatch=dispatch)
    obj = torch.sum(out * torch.cos(out)) + aux
    keys = sorted(tp)
    grads = torch.autograd.grad(obj, [tp[k] for k in keys] + [tx])
    return (out.detach().numpy(), float(aux.detach()),
            (dict(zip(keys, grads[:-1])), grads[-1]))


def _ref_routing(rcfg, p, x):
    """The reference's gate_idx and kept (token, slot) pairs, from its own
    router and scatter-dispatch arithmetic."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax((xt @ jnp.asarray(p["router"])).astype(
        jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, rcfg.top_k)
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, rcfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                              flat[:, None], axis=1)[:, 0]
    return np.asarray(idx), np.asarray(pos < RM._capacity(rcfg, xt.shape[0]))


@pytest.mark.parametrize("name", ["olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("router", ["seeded", "tied", "one_expert"])
@pytest.mark.parametrize("dispatch", ["scatter", "onehot", "sort"])
def test_moe_dispatch_matches_the_reference(name, router, dispatch):
    rcfg, cfg, p, x = _moe_case(name, router)
    ref_idx, ref_keep = _ref_routing(rcfg, p, x)
    xt = _t(x.reshape(-1, x.shape[-1]))
    _, gate_idx, _ = M.route({k: _t(v) for k, v in p.items()}, cfg, xt)
    assert np.array_equal(gate_idx.numpy(), ref_idx)
    flat = gate_idx.reshape(-1)
    pos = torch.cumsum(torch.nn.functional.one_hot(flat, cfg.n_experts),
                       0).gather(1, flat[:, None])[:, 0] - 1
    keep = pos < M._capacity(cfg, xt.shape[0])
    assert np.array_equal(keep.numpy(), ref_keep)
    if router == "tied":
        # lax.top_k's order among equal values: the lower index first
        assert (ref_idx == np.arange(rcfg.top_k)).all()
    if router == "one_expert":
        assert (ref_idx[:, 0] == 3).all() and not ref_keep.all()
    rout, raux, (rgp, rgx) = _ref_moe(rcfg, p, x, dispatch)
    out, aux, (gp, gx) = _port_moe(cfg, p, x, dispatch)
    np.testing.assert_allclose(out, rout, rtol=MOE_RTOL,
                               atol=MOE_RTOL * np.abs(rout).max())
    assert aux == pytest.approx(raux, rel=MOE_RTOL)
    for k, g in list(gp.items()) + [("x", gx)]:
        r = np.asarray(rgx if k == "x" else rgp[k])
        frac = ROUTER_TOP1_ATOL_FRAC if k == "router" and cfg.top_k == 1 \
            else MOE_GRAD_RTOL
        np.testing.assert_allclose(g.numpy(), r, rtol=MOE_GRAD_RTOL,
                                   atol=frac * np.abs(r).max(), err_msg=k)


def test_moe_dispatches_agree_with_each_other():
    """The port's three dispatches on one input, capacity large enough to
    keep every token (as the reference's own test)."""
    cfg = configs.get_reduced("olmoe-1b-7b").replace(capacity_factor=8.0)
    p = M.init_moe(torch.Generator().manual_seed(1), cfg, torch.device("cpu"))
    x = _t(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    outs = [M.moe_block(p, cfg, x, dispatch=d)[0]
            for d in ("scatter", "onehot", "sort")]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- hybrid, remat, dtypes --

def test_hybrid_remainder_group_matches_jax_grad():
    """zamba2 reduced at 5 layers, period 2: groups (0, 1) + shared,
    (2, 3) + shared, then layer 4 alone."""
    rcfg = ref_configs.get_reduced("zamba2-2.7b").replace(n_layers=5)
    cfg = configs.get_reduced("zamba2-2.7b").replace(n_layers=5)
    assert T.n_shared_applications(cfg) == 2 and cfg.n_layers % 2 == 1
    params = _ref_params(rcfg, seed=4)
    batch = jax.tree.map(np.asarray, ref_batch(rcfg, 2, 32, seed=5))
    rl, rloss, rg = _ref_loss_and_grads(rcfg, params, batch)
    pl, ploss, pg = _port_loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(pl, rl, rtol=RTOL,
                               atol=FAMILY_ATOL_FRAC * np.abs(rl).max())
    assert ploss == pytest.approx(rloss, rel=RTOL)
    names = [n for n, _ in T.Transformer(cfg, params=T.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")).leaves()]
    assert "shared.fuse" in names
    for n, g, r in zip(names, pg, rg):
        np.testing.assert_allclose(
            g, r, rtol=GRAD_RTOL,
            atol=FAMILY_GRAD_ATOL_FRAC * float(np.abs(r).max()), err_msg=n)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_remat_gives_the_same_grads_for_each_family(name):
    cfg = configs.get_reduced(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = make_train_batch(cfg, 2, 32, seed=1, device="cpu")
    out = [value_and_grad(cfg.replace(remat=remat), params, batch)
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_bf16_model_keeps_float32_router_and_ssd_leaves():
    for name, leaves in (("olmoe-1b-7b", ("layers.moe.router",)),
                         ("zamba2-2.7b", ("layers.ssd.a_log",
                                          "layers.ssd.dt_bias",
                                          "layers.ssd.d_skip"))):
        cfg = configs.get_reduced(name).replace(dtype="bfloat16",
                                                param_dtype="bfloat16")
        model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
        dtypes = {n: p.dtype for n, p in model.leaves()}
        for n in leaves:
            assert dtypes.pop(n) == torch.float32
        assert set(dtypes.values()) == {torch.bfloat16}
        from repro_torch.convert import params_from_arrays, params_to_arrays
        again = params_from_arrays(params_to_arrays(model), cfg, "cpu")
        for (n, a), (_, b) in zip(again.leaves(), model.leaves()):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        with torch.no_grad():
            loss = model.loss(make_train_batch(cfg, 2, 32, device="cpu"))[0]
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
