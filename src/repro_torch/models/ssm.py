"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060.

Counterpart of ``repro/models/ssm.py``.  The sequence is split into chunks
of Q tokens; within a chunk the recurrence is a masked attention-like
quadratic form, and chunk summary states pass from one chunk to the next
(the reference's ``lax.scan``, a Python loop here, so one chunk's
``(B, Q, Q, H)`` intermediates are built at a time).  ``ssd_decode`` is
the O(1) recurrence of one token, h' = exp(-dt·a)·h + dt·B⊗x, y = C·h,
through ``_conv1d``'s ``state=`` history; it returns the new conv and SSM
states, which the caller writes into its decode state.

Layout: x (B,S,D) -> in_proj -> [z | xc | B | C | dt]; xc passes a short
causal conv1d; heads H = d_inner / headdim P; state N = cfg.ssm_state;
gated RMSNorm on output (y · silu(z)) then out_proj.  ``a_log``,
``dt_bias`` and ``d_skip`` are float32 whatever the param dtype, as in the
reference.  Plain torch ops throughout: the reference's SSD is a jnp graph,
not a Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import dist
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, _pdt, batch_only, rmsnorm

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# The reference's ``log(linspace(1, 16, h, float32))`` (float32 bit
# patterns) for the head counts the registered configs use: 8 (the reduced
# mamba2 and zamba2), 48 (mamba2-780m) and 80 (zamba2-2.7b).  jax's float32
# linspace (a jitted ``start * (1 - step) + stop * step``) and XLA's float32
# log are each an ulp off numpy's and torch's on some of these points, so
# the values are the reference's own, read off its eager init;
# ``tests/test_torch_families.py`` regenerates them.  Other head counts get
# the float64 log of numpy's linspace rounded to float32, which need not be
# the reference's bits.
_A_LOG_BITS = {
    8: (
        0x00000000, 0x3f9293b2, 0x3fd51efa, 0x40005763, 0x40108fe5, 0x401d7de6,
        0x40283e46, 0x40317218,
    ),
    48: (
        0x00000000, 0x3e8dd136, 0x3efcc0b6, 0x3f2bf0aa, 0x3f529b3c, 0x3f74310c,
        0x3f88f04c, 0x3f963ce1, 0x3fa248c9, 0x3fad4b41, 0x3fb76e62, 0x3fc0d2fb,
        0x3fc99320, 0x3fd1c3e0, 0x3fd9767c, 0x3fe0b949, 0x3fe79847, 0x3fee1da3,
        0x3ff4520e, 0x3ffa3d06, 0x3fffe509, 0x4002a7e1, 0x40054116, 0x4007c056,
        0x400a2794, 0x400c788d, 0x400eb4cf, 0x4010ddc0, 0x4012f4a4, 0x4014fa9e,
        0x4016f0b8, 0x4018d7e4, 0x401ab0ff, 0x401c7cd2, 0x401e3c17, 0x401fef7a,
        0x40219797, 0x40233500, 0x4024c83c, 0x402651c9, 0x4027d21a, 0x4029499d,
        0x402ab8b5, 0x402c1fc2, 0x402d7f1c, 0x402ed715, 0x403027fb, 0x40317218,
    ),
    80: (
        0x00000000, 0x3e3204f0, 0x3ea4d014, 0x3ee6d3ae, 0x3f10a58d, 0x3f2ae198,
        0x3f42ace8, 0x3f5871e6, 0x3f6c81e4, 0x3f7f1c78, 0x3f883a23, 0x3f905924,
        0x3f97fc13, 0x3f9f30ea, 0x3fa60367, 0x3fac7d7f, 0x3fb2a7b7, 0x3fb88967,
        0x3fbe28ee, 0x3fc38bdf, 0x3fc8b71f, 0x3fcdaf00, 0x3fd2775a, 0x3fd7139a,
        0x3fdb86cf, 0x3fdfd3be, 0x3fe3fce2, 0x3fe8047e, 0x3febec9c, 0x3fefb71b,
        0x3ff365af, 0x3ff6f9e7, 0x3ffa7533, 0x3ffdd8e5, 0x4000931a, 0x40022f20,
        0x4003c10b, 0x40054956, 0x4006c875, 0x40083ed2, 0x4009acd3, 0x400b12d4,
        0x400c712d, 0x400dc830, 0x400f182b, 0x40106165, 0x4011a423, 0x4012e0a5,
        0x40141727, 0x401547e3, 0x4016730e, 0x401798db, 0x4018b97c, 0x4019d51e,
        0x401aebec, 0x401bfe0f, 0x401d0bb0, 0x401e14f3, 0x401f19fc, 0x40201aed,
        0x402117e7, 0x40221108, 0x4023066d, 0x4023f833, 0x4024e676, 0x4025d14e,
        0x4026b8d4, 0x40279d21, 0x40287e4a, 0x40295c66, 0x402a378a, 0x402b0fc9,
        0x402be536, 0x402cb7e6, 0x402d87e8, 0x402e554f, 0x402f202b, 0x402fe88b,
        0x4030ae80, 0x40317218,
    ),
}


def _a_log(h: int, device: torch.device) -> Tensor:
    if h in _A_LOG_BITS:
        bits = torch.tensor(_A_LOG_BITS[h], dtype=torch.int64)
        return bits.to(torch.int32).view(torch.float32).to(device)
    a = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return torch.from_numpy(a).to(device)


def init_ssd(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    n, g = cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * g * n
    s = d ** -0.5
    proj_out = 2 * di + 2 * g * n + h   # z, xc, B, C, dt
    return {
        "in_proj": _normal(gen, (d, proj_out), cfg, device) * s,
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_dim), cfg, device) * 0.2,
        "conv_b": torch.zeros((conv_dim,), dtype=_pdt(cfg), device=device),
        "a_log": _a_log(h, device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((di,), dtype=_pdt(cfg), device=device),
        "out_proj": _normal(gen, (di, d), cfg, device) * (di ** -0.5),
    }


def _split_proj(cfg: ModelConfig, proj: Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xc = proj[..., di:2 * di]
    bmat = proj[..., 2 * di:2 * di + g * n]
    cmat = proj[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = proj[..., 2 * di + 2 * g * n:]
    return z, xc, bmat, cmat, dt


def _conv1d(cfg: ModelConfig, w: Tensor, b: Tensor, x: Tensor,
            state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Causal depthwise conv over (B, S, C). state: (B, K-1, C) history
    (decode); returns (out, new_state).  The taps are summed as the
    reference's Python ``sum``: from 0, in tap order."""
    k = cfg.ssm_conv
    if state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    out = F.silu(out + b.to(x.dtype))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return out, new_state


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (no threshold, unlike ``F.softplus``), NaN through,
    and its custom JVP's derivative ``exp(x - out)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.where(torch.isnan(x), x,
                          torch.clamp_min(x, 0.0)
                          + torch.log1p(torch.exp(-x.abs())))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * torch.exp(x - out)


def softplus(x: Tensor) -> Tensor:
    return _Softplus.apply(x)


def _ssd_chunked(cfg: ModelConfig, xh: Tensor, dt: Tensor, a: Tensor,
                 bmat: Tensor, cmat: Tensor,
                 init_state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan.
    xh:   (B, S, H, P)    inputs per head
    dt:   (B, S, H)       positive step sizes
    a:    (H,)            positive decay rates (A = -a)
    bmat: (B, S, G, N), cmat: (B, S, G, N); heads map to groups H/G each.
    Returns y (B, S, H, P), final_state (B, H, N, P).
    """
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} not divisible by chunk {q}"
    hg = h // g
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    state = init_state if init_state is not None else \
        torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
    ys = []
    for c in range(s // q):
        rows = slice(c * q, (c + 1) * q)
        xcb, dtcb, bcb, ccb = xh[:, rows], dt[:, rows], bmat[:, rows], \
            cmat[:, rows]
        ldec = dtcb * a[None, None, :]                       # (B,Q,H)
        # inclusive, shard by shard on a DTensor
        cum = dist.along(lambda t: torch.cumsum(t, dim=1), ldec, 1)
        li = cum[:, :, None, :]                              # (B,Q,1,H)
        lj = cum[:, None, :, :]                              # (B,1,Q,H)
        # double where: keep exp() finite on the masked branch, or its inf
        # poisons the gradient through the where
        diff = torch.where(mask, li - lj, 0.0)
        decay = torch.where(mask, torch.exp(-diff), 0.0)     # (B,Q,Q,H)
        cb = torch.einsum("bqgn,bkgn->bqkg", ccb, bcb)       # (B,Q,Q,G)
        cbh = torch.repeat_interleave(cb, hg, dim=-1)        # (B,Q,Q,H)
        w = cbh.to(torch.float32) * decay * dtcb[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", w.to(xh.dtype), xcb)

        # chunk summary: S_c = Σ_j exp(cum_Q - cum_j) dt_j B_j ⊗ x_j
        tail = torch.exp(-(cum[:, -1:, :] - cum))            # (B,Q,H)
        bh = torch.repeat_interleave(bcb, hg, dim=2)         # (B,Q,H,N)
        wb = ((tail * dtcb)[..., None] * bh).to(xh.dtype)    # (B,Q,H,N)
        s_c = torch.einsum("bqhn,bqhp->bhnp", wb, xcb)       # (B,H,N,P)

        # inter-chunk: y += exp(-cum_i) C_i · state_in
        ch = torch.repeat_interleave(ccb, hg, dim=2)         # (B,Q,H,N)
        pref = torch.exp(-cum)
        y_inter = torch.einsum("bqhn,bhnp->bqhp", ch, state) \
            * pref[..., None].to(xh.dtype)

        chunk_decay = torch.exp(-cum[:, -1, :])              # (B,H)
        state = state * chunk_decay[..., None, None].to(state.dtype) + s_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), state


def ssd_block(p: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Full Mamba2 block (training): x (B,S,D) -> (B,S,D)."""
    x = batch_only(x)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_out, _ = _conv1d(cfg, p["conv_w"], p["conv_b"], conv_in)
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    xc = conv_out[..., :di]
    bmat = conv_out[..., di:di + g * n]
    cmat = conv_out[..., di + g * n:]
    b_, s_ = x.shape[0], x.shape[1]
    h, pd = cfg.ssm_heads, cfg.ssm_headdim
    xh = xc.reshape(b_, s_, h, pd)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    a = torch.exp(p["a_log"])
    y, _ = _ssd_chunked(cfg, xh, dt, a, bmat.reshape(b_, s_, g, n),
                        cmat.reshape(b_, s_, g, n))
    y = y + xh * p["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b_, s_, di)
    y = rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    return batch_only(y) @ p["out_proj"].to(x.dtype)


def ssd_decode(p: Params, cfg: ModelConfig, x: Tensor, conv_state: Tensor,
               ssm_state: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """O(1) single-token decode. x: (B,1,D); conv_state (B, K-1, conv_dim);
    ssm_state (B,H,N,P).  Returns (y (B,1,D), new conv state, new SSM
    state), in the reference's dtypes: dt, its softplus and the decay in
    float32, the state update in the state's and the activations' dtype."""
    proj = batch_only(x) @ p["in_proj"].to(x.dtype)
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_out, new_conv = _conv1d(cfg, p["conv_w"], p["conv_b"], conv_in,
                                 state=conv_state)
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    xc = conv_out[..., :di]
    bmat = conv_out[..., di:di + g * n].reshape(-1, g, n)
    cmat = conv_out[..., di + g * n:].reshape(-1, g, n)
    b_ = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_headdim
    hg = h // g
    xh = xc.reshape(b_, h, pd)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0, :]
    a = torch.exp(p["a_log"])
    dec = torch.exp(-dt * a[None, :])                        # (B,H)
    bh = torch.repeat_interleave(bmat, hg, dim=1)            # (B,H,N)
    ch = torch.repeat_interleave(cmat, hg, dim=1)
    new_state = ssm_state * dec[..., None, None].to(ssm_state.dtype) \
        + (dt[..., None, None].to(xh.dtype)
           * bh[..., :, None] * xh[..., None, :])            # (B,H,N,P)
    y = dist.batch_einsum("bhn,bhnp->bhp", ch, new_state)
    y = y + xh * p["d_skip"][None, :, None].to(xh.dtype)
    y = y.reshape(b_, 1, di)
    y = rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    return batch_only(y) @ p["out_proj"].to(x.dtype), new_conv, new_state
