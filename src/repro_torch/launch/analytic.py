"""Analytic FLOPs / HBM-traffic model per (arch × shape) cell.

Counterpart of ``repro/launch/analytic.py``, whose arithmetic it copies
line for line, so every number equals the reference's:

  * MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) -- the "useful"
    flops; the ratio MODEL_FLOPS / counted dot flops
    (``launch/hlo_analysis.py``) exposes the remat, attention and dispatch
    overheads of a step;
  * memory term: the standard napkin model -- weights/optimizer traffic +
    activation checkpoint traffic + logits + KV-cache traffic, per device.

Parameter counts are exact: the port's ``init_params`` run under
``FakeTensorMode`` (shapes and dtypes, no storage), its leaves walked by
path as the reference walks ``jax.eval_shape``'s.  Only the traffic model
is analytic.

The decode cache term counts the cache once, as the reference does: it
multiplies n_attn·B·T·kv·hd by the bytes of one element, so K and V
together are read as one cache (internlm2-1.8b at 16 × 32,768 on one
device: 25.77 GB for a 51.5 GB bf16 cache).  The port keeps the
reference's figure; a bound of its own counts both.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.train.pytree import flatten_with_paths

_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def abstract_params(cfg: ModelConfig) -> Any:
    """``cfg``'s parameter tree as fake CPU tensors: the shapes and dtypes
    of ``init_params``, no storage (of the active ``FakeTensorMode``, if
    there is one)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    with detect_fake_mode() or FakeTensorMode():
        return T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@functools.lru_cache(maxsize=None)
def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Exact parameter counts: total, embedding, expert, active."""
    total = 0
    embed = 0
    expert = 0
    for kp, leaf in flatten_with_paths(abstract_params(cfg)):
        path = "/".join(str(k) for k in kp)
        n = int(leaf.numel())
        total += n
        if "embed/table" in path or path.endswith("lm_head"):
            embed += n
        if "/moe/" in path and ("wg" in path or "wu" in path or "wd" in path) \
                and "shared" not in path:
            expert += n
    active = total - embed - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    # lm_head matmul does participate per token
    head = cfg.d_model * cfg.vocab
    return {"total": float(total), "embed": float(embed),
            "expert": float(expert), "active": float(active),
            "head": float(head)}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N_active·D + lm_head (decode counts one token per sequence)."""
    counts = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence per step
        tokens = shape.global_batch
        mult = 2.0
    return mult * (counts["active"] + counts["head"]) * tokens


def attention_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Quadratic attention term (full-T computation incl. causal waste)."""
    if cfg.family == "ssm":
        # SSD: intra-chunk quadratic + state updates
        q = cfg.ssm_chunk
        if shape.kind == "decode":
            return 2.0 * shape.global_batch * cfg.n_layers * \
                cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim * 3
        tokens = shape.global_batch * shape.seq_len
        per_tok = 2 * q * cfg.ssm_heads * cfg.ssm_headdim \
            + 4 * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim
        f = tokens * cfg.n_layers * per_tok
        return f * (3 if shape.kind == "train" else 1)
    n_attn_layers = cfg.n_layers if cfg.family != "hybrid" else \
        (cfg.n_layers // max(cfg.shared_attn_period, 1))
    if cfg.family == "encdec":
        n_attn_layers = cfg.n_layers * 2 + cfg.n_encoder_layers
    hd, h = cfg.hd, max(cfg.n_heads, 1)
    if shape.kind == "decode":
        # one token attends to the full cache
        f = 4.0 * shape.global_batch * shape.seq_len * h * hd * n_attn_layers
        if cfg.family == "hybrid":
            f += 2.0 * shape.global_batch * cfg.n_layers * \
                cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim * 3
        return f
    tokens = shape.global_batch * shape.seq_len
    f = 4.0 * tokens * shape.seq_len * h * hd * n_attn_layers
    if cfg.family in ("hybrid",):
        q = cfg.ssm_chunk
        per_tok = 2 * q * cfg.ssm_heads * cfg.ssm_headdim \
            + 4 * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim
        f += tokens * cfg.n_layers * per_tok
    return f * (3 if shape.kind == "train" else 1)


def hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, n_devices: int,
              kv_cache_gb: float = 0.0) -> Dict[str, float]:
    """Per-device HBM traffic model for one step."""
    counts = param_counts(cfg)
    wbytes = _BYTES.get(cfg.param_dtype, 2)
    p_dev = counts["total"] * wbytes / n_devices
    d = cfg.d_model
    out: Dict[str, float] = {}
    if shape.kind == "train":
        # weights: fwd read + remat re-read + bwd read; grads write+read;
        # optimizer: m,v read+write (f32) + param write
        opt_mult = 16 if cfg.optimizer == "adamw" else 4
        out["weights"] = p_dev * 3 + counts["total"] / n_devices * \
            (4 * 2 + opt_mult + wbytes)
        # activations: layer-boundary checkpoints write (fwd) + read (bwd)
        tokens_dev = shape.global_batch * shape.seq_len / \
            max(n_devices / _model_axis(n_devices), 1)
        act = cfg.n_layers * tokens_dev * d * 2 * 2  # write+read, bf16
        out["activations"] = act * 2.0  # qkv/ffn extras under remat
        out["logits"] = tokens_dev * cfg.vocab / _model_axis(n_devices) * 4 * 2
    elif shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / \
            max(n_devices / _model_axis(n_devices), 1)
        out["weights"] = p_dev
        out["activations"] = cfg.n_layers * tokens_dev * d * 2 * 2
        out["logits"] = tokens_dev * cfg.vocab / _model_axis(n_devices) * 4
    else:  # decode: weights once per token + cache read/write
        out["weights"] = counts["active" if cfg.n_experts else "total"] \
            * wbytes / n_devices
        kv, hd = max(cfg.n_kv_heads, 1), cfg.hd
        n_attn = cfg.n_layers if cfg.family != "hybrid" else \
            cfg.n_layers // max(cfg.shared_attn_period, 1)
        if cfg.family == "ssm":
            cache = cfg.n_layers * shape.global_batch * cfg.ssm_heads * \
                cfg.ssm_state * cfg.ssm_headdim * 2 * 2
        else:
            kv_bytes = (1.0 + 4.0 / hd) if cfg.kv_cache_dtype == "int8" \
                else 2.0  # int8 + per-(token,head) f32 scale vs bf16
            cache = n_attn * shape.global_batch * shape.seq_len * kv * hd \
                * kv_bytes  # read the full cache
            if cfg.family == "hybrid":
                cache += cfg.n_layers * shape.global_batch * cfg.ssm_heads \
                    * cfg.ssm_state * cfg.ssm_headdim * 2 * 2
        out["kv_cache"] = cache / n_devices
    out["total"] = float(sum(out.values()))
    return out


def _model_axis(n_devices: int) -> int:
    return 16 if n_devices % 16 == 0 else 1
