"""The work a step needs, and the H100's published peaks: the yardstick of
the ``mfu`` metrics, frozen here so that a change to the program cannot
change what its steps are measured against.

``param_counts`` counts the parameters from the shapes of the weights'
layout (``perfbench/weights.py``), as the program's analytic model
(``repro_torch/launch/analytic.py``) counts them from a fake-tensor trace.
``train_step_work`` and ``decode_step_work`` count what one step of a cell
needs, the least work whatever implements it: matrix-product parameters
only (no embedding gather, no norms), causal attention (each query against
the keys at or before it), the cache slots that hold context, each read
once, and the weights read once.  A test holds both, term by term, to the
analytic model's counts.

``min_seconds`` turns a count into the least time on one H100 SXM at
NVIDIA's published dense peaks: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""
from __future__ import annotations

from typing import Dict

from perfbench.weights import leaf_shapes

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def param_counts(cfg) -> Dict[str, float]:
    """Total, embedding (table and head), expert, active and head
    parameter counts, as the program's analytic model counts them."""
    total = embed = expert = norms = 0
    for path, (shape, _) in leaf_shapes(cfg).items():
        n = _numel(shape)
        total += n
        if path in ("embed.table", "lm_head"):
            embed += n
        if ".moe." in f".{path}" and path.rsplit(".", 1)[-1] in (
                "wg", "wu", "wd"):
            expert += n
        if path.endswith("scale"):
            norms += n
    active = total - embed - expert
    if cfg["n_experts"]:
        active += expert * cfg["top_k"] / cfg["n_experts"]
    return {"total": float(total), "embed": float(embed),
            "expert": float(expert), "active": float(active),
            "head": float(cfg["d_model"] * cfg["vocab"]),
            "norms": float(norms)}


def _hd(cfg) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


# --------------------------------------------------- what a cell's step needs

def matmul_params(cfg) -> float:
    """Parameters a token's forward pass multiplies by: every projection,
    the router, the head, and top_k of n_experts of the expert weights;
    not the embedding table (a gather) and not the norms."""
    c = param_counts(cfg)
    return c["active"] - c["norms"] + c["head"]


def train_step_work(cfg, batch: int, seq: int) -> Dict[str, float]:
    """FLOPs of one training step: 6 × matmul parameters × tokens, plus
    causal attention (QK and PV, 4·hd a pair of query and key at or
    before it, per head and layer), three times for forward and
    backward."""
    pairs = batch * seq * (seq + 1) / 2
    attn = 4.0 * pairs * cfg["n_heads"] * _hd(cfg) * cfg["n_layers"] * 3
    flops = 6.0 * matmul_params(cfg) * batch * seq + attn
    return {"flops": flops, "bytes": 0.0}


def decode_step_work(cfg, batch: int, valid: float) -> Dict[str, float]:
    """FLOPs and HBM bytes of one decode step over ``valid`` cache slots a
    row (the mean over the measured steps): 2 × matmul parameters a token,
    attention over the valid slots; bytes for every weight read once (the
    experts that a batch of ``batch`` tokens routes to, in expectation
    under uniform routing), the batch's embedding rows, each valid K and V
    slot read once, one K and V slot written, and the logits written."""
    c = param_counts(cfg)
    wb = _BYTES.get(cfg["param_dtype"], 2)
    ab = _BYTES.get(cfg["dtype"], 2)
    hd, kv, layers = _hd(cfg), cfg["n_kv_heads"], cfg["n_layers"]
    flops = 2.0 * matmul_params(cfg) * batch + \
        4.0 * batch * valid * cfg["n_heads"] * hd * layers
    weights = c["total"] - c["embed"] - c["expert"] + c["head"]
    if cfg["n_experts"]:
        e, k = cfg["n_experts"], cfg["top_k"]
        weights += c["expert"] * (1.0 - (1.0 - k / e) ** batch)
    nbytes = weights * wb + batch * cfg["d_model"] * wb \
        + 2.0 * layers * batch * (valid + 1) * kv * hd * ab \
        + batch * cfg["vocab"] * ab
    return {"flops": flops, "bytes": nbytes}


def min_seconds(work: Dict[str, float]) -> float:
    """The least time of ``work`` on one H100: the larger of its FLOPs at
    the bf16 peak and its bytes at the HBM peak."""
    return max(work["flops"] / PEAK_BF16_FLOPS,
               work["bytes"] / PEAK_HBM_BYTES)
