"""Common transformer layers: RMSNorm, RoPE, GQA attention, MLP, and the
single-token decode attention over a KV cache.

Counterpart of ``repro/models/layers.py``.  Parameters
are plain dicts of tensors, as in the reference; every function takes them
explicitly.  All math is explicitly dtyped as the reference's: params in
``cfg.param_dtype``, activations in ``cfg.dtype``, normalisation and softmax
accumulation in float32 — except the attention scores, which the
reference's ``scores / np.sqrt(hd)`` promotes to float64 whenever jax's x64
mode is on, as it is in the reference's own trainer (its checkpoint module
imports the bitplane codec, which turns x64 on).  The port computes them as
that trainer does.

The reference's sharding hints sit at its places (``_attn_shard_mode``,
``_full_batch_axes``, ``attention``'s ``shard_cb`` and output hint, the
``ctx_mode`` hints of ``gqa_attend_chunked``): ``dist.hint`` redistributes a
``DTensor`` and returns a plain tensor as it is, so with no mesh, or on
plain tensors, the layers compute what they computed without them.
Attention is plain torch ops, as the reference's is a jnp graph (no
Pallas kernel): no ``scaled_dot_product_attention``, whose numerics are not
the reference's.

``attention_decode`` writes the step's K and V into the cache it is given,
in place (the reference's ``dynamic_update_slice`` builds a new array; a
second copy of a full-size cache does not fit the card), at slot
``min(pos, T - 1)``: ``dynamic_update_slice`` clamps its start index, so a
step at ``pos >= T`` overwrites the last slot, and its mask then admits
every slot, as in the reference.  The int8 cache quantises each token's
head row symmetrically (``_quantise_kv``) as the compiled reference does,
XLA's saturating cast included.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.device import DTYPES
from repro_torch.kernels import decode_attn
from repro_torch.models import dist
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]

def _dt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _normal(gen: torch.Generator, shape, cfg: ModelConfig,
            device: torch.device) -> Tensor:
    """A standard normal draw in the param dtype, as
    ``jax.random.normal(key, shape, param_dtype)``."""
    return torch.randn(shape, generator=gen, dtype=_pdt(cfg), device=device)


# ---------------------------------------------------------------- RMSNorm --

def init_rmsnorm(d: int, cfg: ModelConfig, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=_pdt(cfg), device=device)}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * p["scale"].to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------- RoPE --

def rope_frequencies(cfg: ModelConfig,
                     device: Optional[torch.device] = None) -> Tensor:
    """(rot/2,) float32 inverse frequencies, computed in numpy exactly as
    the reference does; ``partial_rotary`` rounds down to an even count."""
    rot = int(cfg.hd * cfg.partial_rotary)
    rot -= rot % 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2, dtype=np.float32)
                                    / rot))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def apply_rope(x: Tensor, positions: Tensor, inv_freq: Tensor) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Angles in
    float32; the rotated part is cast back to ``x.dtype`` and concatenated
    with the pass-through part."""
    rot2 = inv_freq.shape[0]
    angles = positions[..., :, None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x_rot = x[..., : 2 * rot2]
    x_pass = x[..., 2 * rot2:]
    x1 = x_rot[..., 0::2]
    x2 = x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# -------------------------------------------------------------- Attention --

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    p = {"wq": _normal(gen, (d, h * hd), cfg, device) * s,
         "wk": _normal(gen, (d, kv * hd), cfg, device) * s,
         "wv": _normal(gen, (d, kv * hd), cfg, device) * s,
         "wo": _normal(gen, (h * hd, d), cfg, device) * s}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=_pdt(cfg), device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=_pdt(cfg), device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=_pdt(cfg), device=device)
    return p


def _qkv(p: Params, cfg: ModelConfig, x: Tensor, positions: Tensor,
         inv_freq: Tensor, shard_cb=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = batch_only(x)
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    # a DTensor whose heads the model axis does not divide is gathered
    # before the split into heads (DTensor cannot split a sharded dim
    # unevenly)
    q = _whole_heads(q, h).reshape(b, s, h, hd)
    k = _whole_heads(k, kv).reshape(b, s, kv, hd)
    v = _whole_heads(v, kv).reshape(b, s, kv, hd)
    if shard_cb is not None:
        # reshard before RoPE: the rotated tensors are float32 pairs, and
        # the reshard would move twice the bytes
        q, k, v = shard_cb(q, k, v)
    if inv_freq.shape[0]:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    return q, k, v


def gqa_scores_mask(q_pos: Tensor, k_pos: Tensor, is_local: bool,
                    window: int) -> Tensor:
    """Causal mask, restricted to a sliding window when ``is_local`` (a
    Python bool: the port's layer loop is unrolled)."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window > 0 and is_local:
        return causal & (q_pos[:, None] - k_pos[None, :] < window)
    return causal


def batch_only(x: Tensor) -> Tensor:
    """``x`` (B, ...) as a projection takes or gives it: a DTensor keeps
    the sharding of its batch dim and is replicated on every other (a
    partial sum reduced), so that the projection's flattened (B·S) dim is
    sharded on one part only -- in the backward too, where the gradient
    of a projection's output takes the layout of its forward value."""
    return dist.hint_both(x, None, *([dist.REP] * (x.dim() - 1)))


def _whole_heads(x: Tensor, heads: int) -> Tensor:
    """``x`` (B, S, heads·hd), its last dim replicated when it is a
    DTensor and the "model" axis does not divide ``heads``."""
    m = dist.axis_size("model")
    if m > 1 and heads % m:
        return dist.hint(x, None, None, dist.REP)
    return x


def gqa_attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """q: (B,S,H,hd), k/v: (B,T,K,hd), mask: (S,T) or (B,S,T).  Scores as
    an einsum in the input dtype, then widened and divided by sqrt(hd) in
    float64 (the reference trainer's promotion), masked with -1e30,
    softmax, probs cast back to ``q.dtype``.  DTensors go through
    :func:`_gqa_attend_sharded`."""
    if dist.is_dtensor(q):
        return _gqa_attend_sharded(q, k, v, mask)
    return _gqa_attend(q, k, v, mask)


def _gqa_attend_sharded(q: Tensor, k: Tensor, v: Tensor,
                        mask: Tensor) -> Tensor:
    """``gqa_attend`` on DTensors, which GSPMD lays out by itself and
    DTensor cannot: its einsum flattens (batch, kv head) and (group, query
    row) into one dim each, and a flattened dim sharded on two of its parts
    has no sharding propagation.  So each mesh dim gets one part:

    * one that shards q's batch shards q, k, v (and a 3-D mask) on batch;
    * else one that divides the kv heads (with the mesh dims before it
      that split them) shards q, k and v on heads;
    * else one that divides the query rows so shards q and the mask on
      rows, k and v replicated (context parallelism);
    * else (a decode step's one row) q is replicated on it and k, v keep
      their layout (a cache sharded on its slots): the plain einsum then
      propagates, the softmax gathering the scores.

    Without the last case every shard's attention is local, and it runs
    as ``_gqa_attend`` on the local tensors (the reference's
    ``shard_map``); the output is laid out as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    b, s, h, hd = q.shape
    kv = k.shape[2]
    mask_rows = mask.dim() - 2
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    qp, kp, mp = [], [], []
    local = True
    heads, rows = 1, 1      # the mesh sizes already splitting heads, rows
    for i, n in enumerate(mesh.shape):
        cur = q.placements[i]
        if n == 1:
            part = (Replicate(),) * 3
        elif cur.is_shard(0):
            part = (Shard(0), Shard(0),
                    Shard(0) if mask.dim() == 3 else Replicate())
        elif h % (heads * n) == 0 and kv % (heads * n) == 0:
            heads *= n
            part = (Shard(2), Shard(2), Replicate())
        elif s % (rows * n) == 0:
            rows *= n
            part = (Shard(1), Replicate(), Shard(mask_rows))
        else:
            local = False
            part = (Replicate(), Shard(1), Shard(mask.dim() - 1))
        qp.append(part[0])
        kp.append(part[1])
        mp.append(part[2])
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    mask = mask.redistribute(mesh, mp)
    if not local:
        return _gqa_attend(q, k, v, mask)
    out = _gqa_attend(q.to_local(), k.to_local(), v.to_local(),
                      mask.to_local())
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _gqa_attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    q = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = scores.to(torch.float64) / float(np.sqrt(hd))
    if mask.dim() == 2:
        mask_b = mask[None, None, None, :, :]
    else:
        mask_b = mask[:, None, None, :, :]
    scores = torch.where(mask_b, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


# the reference's float32 -1e30, widened with the scores
_NEG = float(np.float32(-1e30))

# query-chunked attention: score tensors are O(B·H·Qc·T) instead of
# O(B·H·S·T) — the reference's choice at 4k+ training sequence lengths
QUERY_CHUNK = 512


def gqa_attend_chunked(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                       k_pos: Tensor, is_local: bool, window: int,
                       chunk: int = QUERY_CHUNK, ctx_mode: str = "") -> Tensor:
    """``gqa_attend`` over query chunks of ``chunk`` rows (the reference's
    ``lax.scan``, a Python loop here): queries are zero-padded to a whole
    number of chunks at position 0, and the padded rows dropped.  With
    ``ctx_mode == "seq"`` each chunk's rows and output are hinted onto
    "model", heads replicated, as the reference hints its stacked chunks
    (no ``_attn_shard_mode`` returns that mode)."""
    b, s, h, hd = q.shape
    if s <= chunk:
        return gqa_attend(q, k, v,
                          gqa_scores_mask(q_pos, k_pos, is_local, window))
    pad = (-s) % chunk
    if pad:
        q = dist.along(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), q, 1)
        q_pos = F.pad(q_pos, (0, pad), value=0)
    outs = []
    for c in range((s + pad) // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        mask = gqa_scores_mask(q_pos[rows], k_pos, is_local, window)
        qc = q[:, rows]
        if ctx_mode == "seq":
            qc = dist.hint(qc, None, "model", dist.REP, dist.REP)
        out = gqa_attend(qc, k, v, mask)
        if ctx_mode == "seq":
            out = dist.hint(out, None, "model", dist.REP, dist.REP)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :s]


def attention(p: Params, cfg: ModelConfig, x: Tensor, positions: Tensor,
              inv_freq: Tensor, is_local: bool) -> Tensor:
    b, s, _ = x.shape
    mode = _attn_shard_mode(cfg, b)

    def shard_cb(q, k, v):
        if mode == "batch":
            # batch-parallel attention: when kv heads don't divide the
            # model axis, the whole attention block shards on batch over
            # (data, model), scores and their gradients device-local
            spec = _full_batch_axes(b)
            q = dist.hint(q, spec, dist.REP, dist.REP, dist.REP)
            k = dist.hint(k, spec, dist.REP, dist.REP, dist.REP)
            v = dist.hint(v, spec, dist.REP, dist.REP, dist.REP)
        elif mode == "seq":
            # context parallelism for forward-only paths: K/V gathered
            k = dist.hint(k, None, None, dist.REP, dist.REP)
            v = dist.hint(v, None, None, dist.REP, dist.REP)
        return q, k, v

    if mode == "batch":
        # the projections run batch-parallel too: the layer boundary may
        # come sequence-sharded
        x = dist.hint(x, _full_batch_axes(b), dist.REP, dist.REP)
    q, k, v = _qkv(p, cfg, x, positions, inv_freq,
                   shard_cb=shard_cb if mode else None)
    pos1d = positions[0] if positions.dim() > 1 else positions
    out = gqa_attend_chunked(q, k, v, pos1d, pos1d, is_local,
                             cfg.local_window, ctx_mode=mode)
    if mode == "batch":
        out = dist.hint(out, _full_batch_axes(b), dist.REP, dist.REP,
                        dist.REP)
    out = batch_only(out.reshape(b, s, -1))
    return batch_only(out @ p["wo"].to(x.dtype))


def _full_batch_axes(b: int):
    # data/model first: on the multi-pod mesh batch 256 divides data*model
    # (256) but not *512 — attention then replicates over "pod"
    axes = []
    size = 1
    for a in ("data", "model", "pod"):
        sz = dist.axis_size(a)
        if sz > 1 and b % (size * sz) == 0:
            axes.append(a)
            size *= sz
    return tuple(axes)


def _attn_shard_mode(cfg: ModelConfig, b: int) -> str:
    """'' (plain: kv heads divide the model axis, or batch too small) |
    'batch' (shard the attention block on batch over data x model).  Only
    with ``cfg.attn_param_replication`` (attention weights replicated over
    "model"): against head-sharded weights the hints would fight the
    layout."""
    msize = dist.axis_size("model")
    if msize <= 1 or cfg.n_kv_heads % msize == 0:
        return ""
    if not cfg.attn_param_replication:
        return ""
    if b % (dist.axis_size("data") * msize) == 0:
        return "batch"
    return ""


def _attend_full_mask_chunked(q: Tensor, k: Tensor, v: Tensor,
                              chunk: int = 0) -> Tensor:
    """Unmasked attention with query chunking (encoders, cross attention):
    queries zero-padded to a whole number of chunks, the padded rows
    dropped."""
    b, s, h, hd = q.shape
    chunk = chunk or QUERY_CHUNK
    if s <= chunk:
        return gqa_attend(q, k, v, torch.ones((s, k.shape[1]), dtype=torch.bool,
                                              device=q.device))
    pad = (-s) % chunk
    if pad:
        q = dist.along(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), q, 1)
    mask = torch.ones((chunk, k.shape[1]), dtype=torch.bool, device=q.device)
    outs = [gqa_attend(q[:, c * chunk:(c + 1) * chunk], k, v, mask)
            for c in range((s + pad) // chunk)]
    return torch.cat(outs, dim=1)[:, :s]


def attention_bidir(p: Params, cfg: ModelConfig, x: Tensor,
                    positions: Tensor, inv_freq: Tensor) -> Tensor:
    """Bidirectional (encoder) attention: no causal mask."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, inv_freq)
    out = _attend_full_mask_chunked(q, k, v)
    out = batch_only(out.reshape(b, s, -1))
    return batch_only(out @ p["wo"].to(x.dtype))


def cross_attention(p: Params, cfg: ModelConfig, x: Tensor, enc_out: Tensor,
                    positions: Tensor, enc_positions: Tensor,
                    inv_freq: Tensor) -> Tensor:
    """Decoder cross attention: queries from ``x``, keys and values from
    ``enc_out``; no RoPE and no biases, as in the reference."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x, enc_out = batch_only(x), batch_only(enc_out)
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (enc_out @ p["wk"].to(x.dtype)).reshape(b, t, kv, hd)
    v = (enc_out @ p["wv"].to(x.dtype)).reshape(b, t, kv, hd)
    out = _attend_full_mask_chunked(q, k, v)
    out = batch_only(out.reshape(b, s, -1))
    return batch_only(out @ p["wo"].to(x.dtype))


# float32 1/127: XLA rewrites the reference's division of the float32-widened
# amax by the constant 127 as a multiply by this reciprocal
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantise_kv(k: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token-per-head symmetric int8 quantisation, as the reference's
    ``layers.py:311-317`` runs compiled (its decode step is a ``lax.scan``):
    ``k`` (..., hd) -> (int8 codes (..., hd), float32 scales (...)).

    Under XLA the scale ``max|k| / 127`` is the float32 product ``max|k| *
    f32(1/127)`` (the division by a constant becomes a multiply by its
    reciprocal), and the stored float32 scale is that product unrounded
    (the round trip through ``k.dtype`` is dropped); the codes divide by it
    rounded to ``k.dtype``, floored at 1e-12 in ``k.dtype``, the quotient
    correctly rounded in ``k.dtype``, rounded half to even and clamped to
    [-128, 127] before the cast: XLA's float-to-int8 convert saturates,
    torch's wraps (in bfloat16 the largest entry's quotient reaches 127.5
    and rounds to 128, which would be stored as -128).  The reciprocal and
    the floor are 0-d tensors on ``k``'s device, so the card computes what
    the CPU does (fault C5)."""
    dev = k.device
    amax = torch.amax(torch.abs(k), dim=-1).to(torch.float32)
    s = amax * torch.full((), _INV_127, dtype=torch.float32, device=dev)
    floor = torch.full((), 1e-12, dtype=k.dtype, device=dev)
    codes = torch.round(k / torch.maximum(s.to(k.dtype), floor)[..., None])
    return torch.clamp(codes, -128, 127).to(torch.int8), s


def _write_slot(cache: Tensor, slot: Tensor, new: Tensor) -> None:
    """``cache.index_copy_(1, slot, new)``: ``new`` (B, 1, ...) written at
    slot ``slot`` (a (1,) int64 tensor) of ``cache`` (B, T, ...), in place.
    A DTensor cache is written shard by shard: ``new`` takes the cache's
    layout on every other dim, and a shard of the slots (dim 1) writes
    the slot only where it holds it, found on the device."""
    if not dist.is_dtensor(cache):
        cache.index_copy_(1, slot, new)
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in cache.placements])
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    local, rows = cache.to_local(), new.to_local()
    n_local = local.shape[1]
    if n_local == cache.shape[1]:
        local.index_copy_(1, slot, rows)
        return
    coord = mesh.get_coordinate()
    first = 0
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):
            first = first * mesh.shape[i] + coord[i]
    at = slot - first * n_local
    held = (at >= 0) & (at < n_local)
    at = at.clamp(0, n_local - 1)
    keep = local.index_select(1, at)
    held = held.reshape((1, 1) + (1,) * (rows.dim() - 2))
    local.index_copy_(1, at, torch.where(held, rows, keep))


def attention_decode(p: Params, cfg: ModelConfig, x: Tensor,
                     cache_k: Tensor, cache_v: Tensor, pos: Tensor,
                     inv_freq: Tensor, is_local: bool,
                     scales: Optional[Tuple[Tensor, Tensor]] = None
                     ) -> Tensor:
    """Single-token decode: x (B,1,D); cache_k/v (B,T,K,hd); pos a 0-d int32
    tensor on the device.  Returns the attention output (B,1,D).

    The step's K and V (with ``cfg.kv_cache_dtype == "int8"``: their int8
    codes, and their float32 scales into ``scales`` = (k_scale, v_scale),
    each (B,T,K)) are written into the caches in place at slot
    ``min(pos, T - 1)``.  The int8 caches are dequantised as
    ``codes.to(dtype) * scales.to(dtype)``, as the reference does.  Where
    ``kernels.decode_attn.admits`` the tensors (on the card, a bf16 cache
    of a registry configuration's head shape) the attention is the
    split-KV kernel, which reads the cache in place over the slots the mask
    admits; everywhere else it is ``gqa_attend``.  The
    ``repro_torch.attend`` span runs from the dequantise through the
    attention's output, after the cache write and before ``wo``."""
    b, t = x.shape[0], cache_k.shape[1]
    positions = pos.expand(b, 1)
    q, k, v = _qkv(p, cfg, x, positions, inv_freq)
    slot = torch.clamp(pos, max=t - 1).to(torch.int64).reshape(1)
    q8 = cfg.kv_cache_dtype == "int8"
    if q8:
        k_s, v_s = scales
        k_q, ks_new = _quantise_kv(k)
        v_q, vs_new = _quantise_kv(v)
        _write_slot(cache_k, slot, k_q)
        _write_slot(cache_v, slot, v_q)
        _write_slot(k_s, slot, ks_new)
        _write_slot(v_s, slot, vs_new)
    else:
        _write_slot(cache_k, slot, k)
        _write_slot(cache_v, slot, v)
    with spans.span("attend", B=b, T=t, H=q.shape[2], K=cache_k.shape[2],
                    hd=q.shape[3], cache=cache_k.dtype, pos=pos):
        if not q8 and decode_attn.admits(q, cache_k, cache_v):
            out = decode_attn.decode_attn(q, cache_k, cache_v, pos, is_local,
                                          cfg.local_window)
        else:
            if q8:
                kf = cache_k.to(x.dtype) * k_s[..., None].to(x.dtype)
                vf = cache_v.to(x.dtype) * v_s[..., None].to(x.dtype)
            else:
                kf, vf = cache_k, cache_v
            k_pos = torch.arange(t, dtype=torch.int32, device=x.device)
            mask = gqa_scores_mask(pos.reshape(1), k_pos, is_local,
                                   cfg.local_window)
            out = gqa_attend(q, kf, vf, mask)
    out = batch_only(out.reshape(b, 1, -1))
    return batch_only(out @ p["wo"].to(x.dtype))


# -------------------------------------------------------------------- MLP --

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = d ** -0.5
    if cfg.act == "swiglu":
        return {"wg": _normal(gen, (d, f), cfg, device) * s,
                "wu": _normal(gen, (d, f), cfg, device) * s,
                "wd": _normal(gen, (f, d), cfg, device) * (f ** -0.5)}
    return {"w1": _normal(gen, (d, f), cfg, device) * s,
            "w2": _normal(gen, (f, d), cfg, device) * (f ** -0.5)}


def mlp(p: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = batch_only(x)
    if cfg.act == "swiglu":
        g = F.silu(x @ p["wg"].to(x.dtype))
        u = x @ p["wu"].to(x.dtype)
        return batch_only((g * u) @ p["wd"].to(x.dtype))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w1"].to(x.dtype), approximate="tanh")
    return batch_only(h @ p["w2"].to(x.dtype))


# ------------------------------------------------------------- Embeddings --

def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> Params:
    return {"table": _normal(gen, (cfg.vocab, cfg.d_model), cfg, device)}


def embed(p: Params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return dist.take_rows(p["table"].to(_dt(cfg)), tokens)


def unembed(p: Params, head: Optional[Tensor], cfg: ModelConfig,
            x: Tensor) -> Tensor:
    x = batch_only(x)
    if cfg.tied_embeddings or head is None:
        logits = x @ p["table"].to(x.dtype).T
    else:
        logits = x @ head.to(x.dtype)
    # a DTensor's gradient comes back with only its batch and vocabulary
    # sharded, as the product's backward flattens (B·S)
    return dist.hint_both(logits, None, dist.REP, None)

