"""The port's decode step (``repro_torch.models.transformer.init_decode_state``
and ``decode_step``, ``layers.attention_decode`` with the int8 KV cache,
``ssm.ssd_decode``, ``train.train_step.make_serve_step`` and the decode
state's converters) against the JAX package on the same weights, tokens
and state.

JAX runs in x64 mode, as in the reference's trainer, where the attention
scores are widened to float64; the port computes them so.  The reference's
step is ``jax.jit`` of its ``make_serve_step``; the port's updates its state
in place, so each step's state is read out before the next.

Tolerances are ``tests/test_torch_models.py``'s: logits and every float
state leaf rtol ``RTOL`` = 1e-5 with atol ``ATOL`` = 1e-5 for the dense
configs, atol ``FAMILY_ATOL_FRAC`` = 1e-5 of the leaf's (or the logits')
largest magnitude for the others; ``pos`` and the int8 codes exact.  The
largest gap measured over 12 steps of every reduced config, as a fraction
of the leaf's largest magnitude, is 1.1e-6 (zamba2's shared-block cache),
the logits' 9.0e-7 (zamba2).

The int8 quantiser is held bit for bit: a bfloat16 model whose ``wk`` and
``wv`` are the identity and whose rotary frequencies are zeros stores
exactly the chosen K/V rows, so both packages quantise the same rows, among
them rows whose largest entry's quotient reaches 127.5 and rounds to 128,
which XLA's convert saturates to 127 (torch's cast would wrap it to -128).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro._x64  # noqa: E402,F401  (the reference trainer's mode)
from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train.train_step import make_serve_step as ref_serve_step  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (decode_state_from_arrays,  # noqa: E402
                                 decode_state_to_arrays, params_from_arrays)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.train.train_step import make_serve_step  # noqa: E402

from test_torch_models import (ATOL, DENSE, FAMILY_ATOL_FRAC,  # noqa: E402
                               RTOL, _ref_params)

B = 2
STEPS = 12
FAMILY_OF = {n: ref_configs.get_reduced(n).family for n in ref_configs.names()}
# one reduced config per family
FAMILIES = ("internlm2-1.8b", "olmoe-1b-7b", "mamba2-780m", "zamba2-2.7b",
            "seamless-m4t-medium", "phi-3-vision-4.2b")


def _cfgs(name, **kw):
    return (ref_configs.get_reduced(name).replace(**kw),
            configs.get_reduced(name).replace(**kw))


def _assert_close(got, want, name, what):
    atol = ATOL if name in DENSE else \
        FAMILY_ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=f"{name}: {what}")


def _decode_both(name, max_seq, steps, seed=7, **kw):
    """Decode ``steps`` tokens from ``init_decode_state`` in both packages
    (encdec's ``enc_out`` a seeded array carried across) and hold every
    step's logits and state leaves to the reference."""
    cr, cp = _cfgs(name, **kw)
    params = _ref_params(cr)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cr.vocab, (B, steps)).astype(np.int32)
    rs = RT.init_decode_state(cr, B, max_seq)
    if cr.family == "encdec":
        rs["enc_out"] = jnp.asarray(rng.standard_normal(
            (B, max_seq, cr.d_model)).astype(np.float32))
    ps = decode_state_from_arrays(jax.tree.map(np.asarray, rs), cp,
                                  device="cpu")
    tree = params_from_arrays(params, cp, device="cpu").tree()
    rstep = jax.jit(ref_serve_step(cr))
    pstep = make_serve_step(cp)
    rp = jax.tree.map(jnp.asarray, params)
    for t in range(steps):
        rl, rs = rstep(rp, rs, jnp.asarray(toks[:, t:t + 1]))
        pl, ps = pstep(tree, ps, torch.from_numpy(toks[:, t:t + 1]))
        assert pl.shape == (B, 1, cr.vocab)
        _assert_close(pl.numpy(), np.asarray(rl), name, f"logits, step {t}")
        got = decode_state_to_arrays(ps)
        assert set(got) == set(rs)
        for k, v in rs.items():
            v = np.asarray(v)
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            if v.dtype.kind in "iu":
                assert np.array_equal(got[k], v), (name, k, t)
            else:
                _assert_close(got[k], v, name, f"{k}, step {t}")
        assert int(ps["pos"]) == t + 1
    return ps


@pytest.mark.parametrize("name", ref_configs.names())
def test_decode_matches_the_reference(name):
    """Every registered config, reduced: 12 steps with the same tokens."""
    _decode_both(name, max_seq=16, steps=STEPS)


def test_gemma3_decodes_past_its_window():
    """gemma3's local layers (window 8) over 20 steps: from step 8 on, the
    window drops the oldest slots."""
    cr, _ = _cfgs("gemma3-1b")
    assert cr.local_window == 8 and any(RT.layer_flags(cr)["is_local"])
    _decode_both("gemma3-1b", max_seq=24, steps=20)


def test_steps_past_max_seq_write_the_last_slot():
    """max_seq 4, 6 steps: the reference's ``dynamic_update_slice`` clamps
    its start, so steps 4 and 5 overwrite slot 3 and attend to every slot;
    the port's state and logits follow it."""
    ps = _decode_both("internlm2-1.8b", max_seq=4, steps=6)
    assert int(ps["pos"]) == 6


@pytest.mark.parametrize("name", ("qwen2.5-14b", "olmoe-1b-7b",
                                  "phi-3-vision-4.2b"))
def test_int8_decode_within_a_code_of_the_reference(name):
    """The dense, moe and vlm families with the int8 cache (float32), 8
    steps.  The codes are the rounding of float quotients, so a last-bit
    difference in K or V (the matmul sums in another order) can move a code
    by one: codes within one, scales within rtol ``RTOL``, logits within
    2e-3 of their largest (measured 9.6e-4, qwen2.5)."""
    cr, cp = _cfgs(name, kv_cache_dtype="int8")
    params = _ref_params(cr)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cr.vocab, (B, 8)).astype(np.int32)
    rs = RT.init_decode_state(cr, B, 8)
    ps = T.init_decode_state(cp, B, 8, device="cpu")
    tree = params_from_arrays(params, cp, device="cpu").tree()
    rstep = jax.jit(ref_serve_step(cr))
    rp = jax.tree.map(jnp.asarray, params)
    for t in range(8):
        rl, rs = rstep(rp, rs, jnp.asarray(toks[:, t:t + 1]))
        pl, ps = T.decode_step(tree, cp, ps,
                               torch.from_numpy(toks[:, t:t + 1]))
        rl = np.asarray(rl)
        got = decode_state_to_arrays(ps)
        for k in ("k", "v"):
            assert got[k].dtype == np.int8
            assert np.abs(got[k].astype(int) - np.asarray(rs[k])).max() <= 1
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[k], np.asarray(rs[k]), rtol=RTOL)
        assert np.abs(pl.numpy() - rl).max() <= 2e-3 * np.abs(rl).max()


# ------------------------------------------------------ the int8 quantiser --

KV, HD = 2, 128
QB, QSTEPS = 16, 32


@jax.jit
def _rounded(k):
    """The reference's rounded quotients (``layers.py:312-315``), compiled
    as its decode step runs them."""
    s = jnp.max(jnp.abs(k), axis=-1) / 127.0
    return jnp.round(k / jnp.maximum(s, 1e-12)[..., None])


def _saturating(rows):
    """Per (row, head): the reference's quotient rounds beyond int8, where
    its convert saturates."""
    r = _rounded(jnp.asarray(rows, jnp.bfloat16))
    return np.asarray((r > 127) | (r < -128)).any(-1)


def _quantiser_rows(seed=11):
    """(QSTEPS, QB, KV, HD) float32 rows, exact in bfloat16: half of the
    token rows have a saturating head, the rest do not, plus an all-zero
    row (the 1e-12 floor) and a row with one nonzero entry."""
    rng = np.random.default_rng(seed)
    pool = np.asarray(jnp.asarray(rng.standard_normal((8192, KV, HD)),
                                  jnp.bfloat16).astype(jnp.float32))
    sat = _saturating(pool).any(-1)
    n = QSTEPS * QB
    rows = np.concatenate([pool[sat][: n // 2], pool[~sat][: n - n // 2]])
    rows[1] = 0.0
    rows[2] = 0.0
    rows[2, 1, 5] = -3.0
    return rows[rng.permutation(n)].reshape(QSTEPS, QB, KV, HD)


def _identity_attention(cfg):
    """Attention parameters whose K and V projections are the identity
    (d_model = kv * hd) and whose Q and output projections are seeded."""
    rng = np.random.default_rng(4)
    d = cfg.d_model
    eye = np.eye(d, dtype=np.float32)
    return {"wq": rng.standard_normal((d, d)).astype(np.float32) / 16,
            "wk": eye, "wv": eye,
            "wo": rng.standard_normal((d, d)).astype(np.float32) / 16}


def test_int8_quantiser_bit_equal_to_the_reference_on_saturating_rows():
    cr, cp = _cfgs("internlm2-1.8b", d_model=KV * HD, n_heads=KV,
                   n_kv_heads=KV, head_dim=HD, dtype="bfloat16",
                   param_dtype="bfloat16", kv_cache_dtype="int8")
    rows = _quantiser_rows()
    n_sat = int(_saturating(rows).sum())
    assert n_sat >= 100
    p = _identity_attention(cr)
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    rot = RL.rope_frequencies(cr).shape[0]
    ref_attn = jax.jit(RL.attention_decode, static_argnums=1)
    zeros = RT.init_decode_state(cr, QB, QSTEPS)
    rk, rv, rks, rvs = (zeros[k][0] for k in ("k", "v", "k_scale",
                                              "v_scale"))
    st = T.init_decode_state(cp, QB, QSTEPS, device="cpu")
    for t in range(QSTEPS):
        x = rows[t].reshape(QB, 1, KV * HD)
        out, rk, rv, (rks, rvs) = ref_attn(
            rp, cr, jnp.asarray(x, jnp.bfloat16), rk, rv, jnp.int32(t),
            jnp.zeros((rot,), jnp.float32), jnp.asarray(False),
            (rks, rvs))
        got = L.attention_decode(
            tp, cp, torch.from_numpy(x).to(torch.bfloat16), st["k"][0],
            st["v"][0], torch.tensor(t, dtype=torch.int32),
            torch.zeros(rot), False, (st["k_scale"][0], st["v_scale"][0]))
        # the attention output is bfloat16 products summed in another
        # order: within two bfloat16 ulps of its largest
        want = np.asarray(out.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max())
    for got, want in ((st["k"][0], rk), (st["v"][0], rv),
                      (st["k_scale"][0], rks), (st["v_scale"][0], rvs)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # the stored rows are the chosen ones, and the saturating rows hold
    # +127 where torch's bare cast of the rounded quotient would wrap
    kt = torch.from_numpy(rows).to(torch.bfloat16)
    codes, scales = L._quantise_kv(kt)
    assert torch.equal(codes.transpose(0, 1), st["k"][0])
    assert torch.equal(scales.transpose(0, 1), st["k_scale"][0])
    floor = torch.tensor(1e-12, dtype=torch.bfloat16)
    wrapped = torch.round(kt / torch.maximum(scales.to(torch.bfloat16),
                                             floor)[..., None])
    assert int((wrapped.to(torch.int8) != codes).any(-1).sum()) == n_sat


def test_quantiser_zero_row_takes_the_floor():
    k = torch.zeros((1, 1, 2, 8), dtype=torch.bfloat16)
    k[0, 0, 1, 3] = 2.0
    codes, scales = L._quantise_kv(k)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert torch.equal(codes[0, 0, 0], torch.zeros(8, dtype=torch.int8))
    assert int(codes[0, 0, 1, 3]) == 127 and float(scales[0, 0, 0]) == 0.0


# ------------------------------------------- mirrors of the reference's --

@pytest.mark.parametrize("name", ["qwen2.5-14b", "mamba2-780m",
                                  "olmoe-1b-7b", "gemma3-1b"])
def test_decode_matches_prefill(name):
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` on the
    port: greedy decode logits match the teacher-forced forward's (rtol
    2e-3, atol 2e-3)."""
    cfg = configs.get_reduced(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 8)).astype(np.int32))
    with torch.no_grad():
        full, _ = T.forward(params, cfg, {"tokens": toks})
    state = T.init_decode_state(cfg, batch=1, max_seq=8, device="cpu")
    outs = []
    for t in range(8):
        lg, state = T.decode_step(params, cfg, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_int8_kv_cache_decode_close_to_prefill():
    """``::test_int8_kv_cache_decode_close_to_prefill`` on the port: the
    int8 cache's logits within 0.05 of the largest prefill logit."""
    cfg_ref = configs.get_reduced("qwen2.5-14b")
    cfg = cfg_ref.replace(kv_cache_dtype="int8")
    params = T.init_params(cfg_ref, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 8)).astype(np.int32))
    with torch.no_grad():
        full, _ = T.forward(params, cfg_ref, {"tokens": toks})
    state = T.init_decode_state(cfg, batch=1, max_seq=8, device="cpu")
    assert state["k"].dtype == torch.int8
    outs = []
    for t in range(8):
        lg, state = T.decode_step(params, cfg, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    rel = float((torch.stack(outs, 1) - full).abs().max() / full.abs().max())
    assert rel < 0.05, rel


# ------------------------------------------------------ the serve step --

@pytest.mark.parametrize("name", FAMILIES)
def test_serve_step_builds_no_graph(name):
    """``make_serve_step`` over ``nn.Parameter`` leaves: no output or state
    leaf requires grad, and the state is updated in place."""
    cfg = configs.get_reduced(name)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    state = T.init_decode_state(cfg, 2, 4, device="cpu")
    before = {k: v.data_ptr() for k, v in state.items() if k != "pos"}
    step = make_serve_step(cfg)
    token = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(2):
        logits, state = step(model.tree(), state, token)
        assert not logits.requires_grad and logits.grad_fn is None
        assert not any(v.requires_grad for v in state.values())
    assert {k: v.data_ptr() for k, v in state.items() if k != "pos"} == \
        before
    assert int(state["pos"]) == 2 and state["pos"].dtype == torch.int32


def test_decode_wants_cuda_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_state_from_arrays(decode_state_to_arrays(
            T.init_decode_state(cfg, 1, 4, device="cpu")), cfg)


# ------------------------------------------------------- the state's layout --

LAYOUTS = [(n, {}) for n in ref_configs.names()] + [
    ("internlm2-1.8b", {"kv_cache_dtype": "int8"}),
    ("olmoe-1b-7b", {"kv_cache_dtype": "int8"}),
    ("phi-3-vision-4.2b", {"kv_cache_dtype": "int8"}),
    ("zamba2-2.7b", {"dtype": "bfloat16"})]


@pytest.mark.parametrize("name,kw", LAYOUTS)
def test_init_decode_state_equals_the_reference_layout(name, kw):
    cr, cp = _cfgs(name, **kw)
    ref = RT.init_decode_state(cr, 3, 5)
    got = T.init_decode_state(cp, 3, 5, device="cpu")
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == v.dtype.name, k
        assert not got[k].any()


@pytest.mark.parametrize("name,kw", LAYOUTS)
def test_decode_state_round_trip(name, kw):
    """A state part-way through a sequence (every leaf seeded) through
    ``decode_state_to_arrays`` and ``decode_state_from_arrays``: every leaf
    back bit for bit with its dtype; a state of another family's layout is
    refused."""
    _, cp = _cfgs(name, **kw)
    state = T.init_decode_state(cp, 2, 6, device="cpu")
    gen = torch.Generator().manual_seed(9)
    for k, v in state.items():
        if v.dtype.is_floating_point:
            v.copy_(torch.randn(v.shape, generator=gen))
        else:
            v.copy_(torch.randint(-128, 128, v.shape, generator=gen))
    arrays = decode_state_to_arrays(state)
    back = decode_state_from_arrays(arrays, cp, device="cpu")
    assert list(back) == list(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    other = "mamba2-780m" if FAMILY_OF[name] != "ssm" else "internlm2-1.8b"
    with pytest.raises(ValueError, match="decode state keys"):
        decode_state_from_arrays(arrays, configs.get_reduced(other),
                                 device="cpu")
