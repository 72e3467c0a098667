"""The plain reference model's common parts, in float32 PyTorch with TF32
off; each family's layer is in ``perfbench/reference/layouts``.  It
imports nothing of the program.

It follows the model the program implements: RMSNorm (eps 1e-6, scale
after normalising), rotary embedding on interleaved pairs (inverse
frequencies ``1 / theta ** (arange(0, hd, 2) / hd)`` and angles in
float32), scores over ``sqrt(hd)``, the auxiliary losses at 0.01, and the
mean next-token cross entropy over labels >= 0.

``fp8=True`` is the control: every matrix product takes both operands
rounded to float8 e4m3 with a per-tensor scale, the nearest precision
below the bf16 that the configurations state.

Weights come as a dict of float32 leaves by path (``perfbench.weights``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from perfbench.reference import layouts

Tensor = torch.Tensor
Leaves = Dict[str, Tensor]

_E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: Tensor) -> Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in float32;
    the gradient passes through the rounding unchanged (the backward's
    products take the rounded operands)."""
    xd = x.detach()
    s = xd.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return x + ((xd / s).to(torch.float8_e4m3fn).to(torch.float32) * s - xd)


def mm(a: Tensor, b: Tensor, fp8: bool) -> Tensor:
    if fp8:
        a, b = q8(a), q8(b)
    return a @ b


def ein(eq: str, a: Tensor, b: Tensor, fp8: bool) -> Tensor:
    if fp8:
        a, b = q8(a), q8(b)
    return torch.einsum(eq, a, b)


def head_dim(cfg) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def rmsnorm(scale: Tensor, x: Tensor, eps: float = 1e-6) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (B, S, H, hd); positions (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(x.device)
    ang = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def qkv(cfg, w: Leaves, l: int, h: Tensor, positions: Tensor, fp8: bool
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Layer ``l``'s rotated q (B, S, KV, G, hd), k and v (B, S, KV, hd)."""
    b, s, _ = h.shape
    hd, kv = head_dim(cfg), cfg["n_kv_heads"]
    g = cfg["n_heads"] // kv
    q = mm(h, w["layers.attn.wq"][l], fp8).reshape(b, s, kv * g, hd)
    k = mm(h, w["layers.attn.wk"][l], fp8).reshape(b, s, kv, hd)
    v = mm(h, w["layers.attn.wv"][l], fp8).reshape(b, s, kv, hd)
    q = rope(q, positions, cfg["rope_theta"]).reshape(b, s, kv, g, hd)
    return q, rope(k, positions, cfg["rope_theta"]), v


def causal_attention(q: Tensor, k: Tensor, v: Tensor, fp8: bool) -> Tensor:
    """q (B, S, KV, G, hd) over k, v (B, S, KV, hd), each query against
    the keys at or before it -> (B, S, KV·G·hd)."""
    b, s, kv, g, hd = q.shape
    sc = ein("bskgd,btkd->bkgst", q, k, fp8) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    return ein("bkgst,btkd->bskgd", p, v, fp8).reshape(b, s, kv * g * hd)


def context_attention(q: Tensor, k: Tensor, v: Tensor, kc: Tensor,
                      vc: Tensor, fp8: bool) -> Tensor:
    """Decode queries q (B, n, KV, G, hd) over a context kc, vc (B, C, KV,
    hd), all visible, and the request's own keys k, v (B, n, KV, hd), each
    query against those at or before it -> (B, n, KV·G·hd)."""
    b, n, kv, g, hd = q.shape
    c = kc.shape[1]
    sc = ein("bnkgd,bckd->bkgnc", q, kc, fp8) / math.sqrt(hd)
    sn = ein("bnkgd,bmkd->bkgnm", q, k, fp8) / math.sqrt(hd)
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    sn = sn.masked_fill(~mask, float("-inf"))
    p = torch.softmax(torch.cat([sc, sn], -1), -1)
    out = ein("bkgnc,bckd->bnkgd", p[..., :c], vc, fp8) + \
        ein("bkgnm,bmkd->bnkgd", p[..., c:], v, fp8)
    return out.reshape(b, n, kv * g * hd)


def decoder_layer(cfg, w: Leaves, l: int, x: Tensor, positions: Tensor,
                  attend: Callable, ffn: Callable, groups: "Groups",
                  fp8: bool, stats: Optional[dict] = None
                  ) -> Tuple[Tensor, Tensor]:
    """One pre-norm layer: ``attend(q, k, v)`` over the rotated
    projections, then ``ffn(cfg, w, l, h, groups, fp8, stats) -> (y,
    aux)``.  Returns (x, the layer's auxiliary loss)."""
    h = rmsnorm(w["layers.norm1.scale"][l], x)
    q, k, v = qkv(cfg, w, l, h, positions, fp8)
    x = x + mm(attend(q, k, v), w["layers.attn.wo"][l], fp8)
    y, aux = ffn(cfg, w, l, rmsnorm(w["layers.norm2.scale"][l], x), groups,
                 fp8, stats)
    return x + y, aux


def logits_of(cfg, w: Leaves, x: Tensor, fp8: bool) -> Tensor:
    return mm(rmsnorm(w["final_norm.scale"], x), w["lm_head"], fp8)


def embed(w: Leaves, tokens: Tensor) -> Tensor:
    return w["embed.table"][tokens.to(torch.int64)]


class Groups:
    """How a call of the MoE layer groups its tokens: ``"batch"`` routes
    all (B, S) tokens of a training step as one group; ``"step"`` routes
    each decode step's B tokens (one a row) as one group."""

    def __init__(self, kind: str):
        self.kind = kind

    def __call__(self, h: Tensor) -> Tensor:
        if self.kind == "batch":
            return h.reshape(1, -1, h.shape[-1])
        return h.transpose(0, 1)

    def inverse(self, y: Tensor, shape) -> Tensor:
        if self.kind == "batch":
            return y.reshape(shape)
        return y.transpose(0, 1)


def train_loss(cfg, w: Leaves, batch: Dict[str, Tensor], fp8: bool = False,
               checkpoint: Optional[Callable] = None) -> Tensor:
    """Mean next-token cross entropy over labels >= 0 plus 0.01 of the
    summed MoE auxiliary loss; each layer under ``checkpoint`` when
    given."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    groups = Groups("batch")

    fam = layouts.of(cfg)

    def layer(l: int, x: Tensor) -> Tuple[Tensor, Tensor]:
        return fam.layer(cfg, w, l, x, pos,
                         lambda q, k, v: causal_attention(q, k, v, fp8),
                         groups, fp8)

    x = embed(w, tokens)
    aux = x.new_zeros(())
    for l in range(cfg["n_layers"]):
        if checkpoint is not None:
            x, a = checkpoint(layer, l, x, use_reentrant=False)
        else:
            x, a = layer(l, x)
        aux = aux + a
    logits = logits_of(cfg, w, x, fp8)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).to(torch.int64)
                        [..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = torch.sum((logz - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)
    return ce + 0.01 * aux
