"""Mixture-of-Experts layer: top-k router + capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``: the router (float32 whatever the
param dtype), the Switch load-balancing aux loss, and the three dispatches
of the reference — ``scatter`` (the configs' default: cumsum queue
positions, a scatter into expert space and a gather back), ``onehot``
(dense (N, E, C) dispatch masks) and ``sort`` (argsort by expert, then a
scatter-add back into token space).  Expert weights are stacked (E, D, F);
a shared expert (Llama-4 style) adds to the routed output when
``cfg.n_shared_experts`` is set.  ``_expert_ffn`` carries the reference's
four sharding hints (``dist.hint``: expert queues on "model" and capacity
on "data"), which leave plain tensors as they are, and the
``repro_torch.experts`` span (``repro_torch.spans``).

Determinism: ``jax.lax.top_k`` returns the lower index first among equal
probabilities; the port takes a stable descending sort, which does the
same.  A dropped (token, slot) pair writes the pad row ``E * C``, which
is discarded, so which of its duplicate writes lands does not matter.  The
sort dispatch's ``index_add_`` sums a token's contributions with atomics
on the card, in no fixed order (no config selects that dispatch).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models import dist
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, batch_only

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    p = {"router": torch.randn((d, e), generator=gen, dtype=torch.float32,
                               device=device) * s,
         "wg": _normal(gen, (e, d, f), cfg, device) * s,
         "wu": _normal(gen, (e, d, f), cfg, device) * s,
         "wd": _normal(gen, (e, f, d), cfg, device) * (f ** -0.5)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wg"] = _normal(gen, (d, fs), cfg, device) * s
        p["shared_wu"] = _normal(gen, (d, fs), cfg, device) * s
        p["shared_wd"] = _normal(gen, (fs, d), cfg, device) * (fs ** -0.5)
    return p


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """``F.one_hot(idx, n)`` (int64) as a comparison on the device:
    ``F.one_hot`` reads the indices' range back to the host to check it,
    a sync each call, which a traced step cannot make."""
    return (idx[..., None] == torch.arange(n, dtype=idx.dtype,
                                           device=idx.device)).to(
        torch.int64)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap - cap % -8 if cap % 8 else cap, 8)  # round up to 8


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values,
    descending, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, cfg: ModelConfig, xt: Tensor
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """xt (N, D) -> (gate_vals (N, k) renormalised, gate_idx (N, k), aux).
    Logits in the compute dtype, softmax in float32."""
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    # load-balancing aux loss (Switch): E * Σ_e f_e · p_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(_one_hot(gate_idx[:, 0], cfg.n_experts).to(
        torch.float32), dim=0)
    aux = float(cfg.n_experts) * torch.sum(me * ce)
    return gate_vals, gate_idx, aux


def moe_block(p: Params, cfg: ModelConfig, x: Tensor,
              dispatch: str = "scatter") -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Dispatch: scatter | onehot | sort."""
    b, s, d = x.shape
    xt = batch_only(x).reshape(b * s, d)
    gate_vals, gate_idx, aux = route(p, cfg, xt)
    cap = _capacity(cfg, b * s)
    if dispatch == "onehot":
        out = _dispatch_onehot(p, cfg, xt, gate_vals, gate_idx, cap)
    elif dispatch == "scatter":
        out = _dispatch_scatter(p, cfg, xt, gate_vals, gate_idx, cap)
    else:
        out = _dispatch_sort(p, cfg, xt, gate_vals, gate_idx, cap)
    if cfg.n_shared_experts:
        g = F.silu(xt @ p["shared_wg"].to(xt.dtype))
        u = xt @ p["shared_wu"].to(xt.dtype)
        out = out + (g * u) @ p["shared_wd"].to(xt.dtype)
    return batch_only(out.reshape(b, s, d)), aux


def _expert_ffn(p: Params, xe: Tensor, kept: Tensor, expert: Tensor
                ) -> Tensor:
    """xe: (E, C, D) -> (E, C, D) via per-expert SwiGLU, the expert queues
    hinted onto (E -> "model", C -> "data") so the expert matmuls run
    sharded.  ``kept`` (the dispatch's mask of the (token, slot) pairs its
    queues hold, with a trailing expert dim in the onehot dispatch) and
    ``expert`` (each pair's expert) are read by the
    ``repro_torch.experts`` span alone."""
    e, c, d = xe.shape
    with spans.span("experts", E=e, C=c, d=d, d_ff=p["wg"].shape[-1],
                    dtype=xe.dtype, weights=p["wg"].dtype, kept=kept,
                    expert=expert):
        xe = dist.hint(xe, "model", "data", None)
        g = F.silu(torch.bmm(xe, p["wg"].to(xe.dtype)))
        u = torch.bmm(xe, p["wu"].to(xe.dtype))
        g = dist.hint(g, "model", "data", None)
        u = dist.hint(u, "model", "data", None)
        out = torch.bmm(g * u, p["wd"].to(xe.dtype))
        return dist.hint(out, "model", "data", None)


def _dispatch_onehot(p: Params, cfg: ModelConfig, xt: Tensor,
                     gate_vals: Tensor, gate_idx: Tensor, cap: int) -> Tensor:
    """Switch-style dense dispatch: (N, E, C) one-hot dispatch and combine
    tensors, then einsums."""
    n, _ = xt.shape
    e = cfg.n_experts
    expert_onehot = _one_hot(gate_idx, e).to(torch.float32)      # (N,k,E)
    # position of each (token, slot) within its expert queue
    pos_in_expert = torch.cumsum(expert_onehot.reshape(n * cfg.top_k, e),
                                 dim=0).reshape(n, cfg.top_k, e) - 1.0
    keep = (pos_in_expert < cap) & (expert_onehot > 0)
    pos_clipped = torch.clamp(pos_in_expert, 0, cap - 1).to(torch.int64)
    cap_onehot = _one_hot(pos_clipped, cap).to(torch.float32)    # (N,k,E,C)
    kept = expert_onehot * keep.to(torch.float32)
    dispatch = torch.einsum("nke,nkec->nec", kept, cap_onehot)   # (N,E,C)
    combine = torch.einsum("nk,nke,nkec->nec",
                           gate_vals.to(torch.float32), kept, cap_onehot)
    xe = torch.einsum("nec,nd->ecd", dispatch.to(xt.dtype), xt)
    ye = _expert_ffn(p, xe, keep, gate_idx)
    return torch.einsum("nec,ecd->nd", combine.to(xt.dtype), ye)


def _dispatch_scatter(p: Params, cfg: ModelConfig, xt: Tensor,
                      gate_vals: Tensor, gate_idx: Tensor, cap: int) -> Tensor:
    """Cumsum queue positions + expert-space scatter/gather: dispatch is a
    scatter into the (E·C + 1, D) expert space (its last row the pad row
    that dropped pairs write), combine a gather from it, and each token's
    k contributions a local sum."""
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_expert = gate_idx.reshape(-1)                        # (N*k,)
    onehot = _one_hot(flat_expert, e)                         # (N*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                # exclusive
    pos_in_e = torch.gather(pos, 1, flat_expert[:, None])[:, 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_expert * cap + pos_in_e, e * cap)
    xt_rep = torch.repeat_interleave(xt, k, dim=0) if k > 1 else xt
    xq = dist.put_rows(e * cap + 1, slot, xt_rep)
    # the gather back reads any expert's rows: a DTensor's expert space
    # is gathered first (DTensor cannot index a dim sharded on two axes)
    ye = _expert_ffn(p, xq[:-1].reshape(e, cap, d), keep, flat_expert)
    ye = dist.hint(ye, dist.REP, dist.REP, None).reshape(e * cap, d)
    gathered = dist.take_rows(ye, torch.clamp_max(slot, e * cap - 1))
    contrib = torch.where(keep[:, None], gathered, 0.0) \
        * gate_vals.reshape(-1)[:, None].to(xt.dtype)
    if k == 1:
        return contrib
    return torch.sum(contrib.reshape(n, k, d), dim=1)         # local sum


def _dispatch_sort(p: Params, cfg: ModelConfig, xt: Tensor,
                   gate_vals: Tensor, gate_idx: Tensor, cap: int) -> Tensor:
    """Sort-based dispatch: a stable argsort of the (token, slot) pairs by
    expert, the pairs gathered into (E, C) queues, the expert FFNs, and a
    scatter-add back into token space."""
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    flat_expert = gate_idx.reshape(-1)                        # (N*k,)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), k)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    # position within expert queue
    same = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      (sorted_expert[1:] == sorted_expert[:-1]).to(
                          torch.int64)])
    idx = torch.arange(n * k, dtype=torch.int64, device=dev)
    seg_start = torch.cummax(torch.where(same == 0, idx, 0), dim=0).values
    pos = idx - seg_start
    keep = pos < cap
    slot = torch.where(keep, sorted_expert * cap + pos, e * cap)  # drop -> pad
    xq = dist.put_rows(e * cap + 1, slot, xt[sorted_token])
    ye = _expert_ffn(p, xq[:-1].reshape(e, cap, d), keep, sorted_expert)
    ye = dist.hint(ye, dist.REP, dist.REP, None).reshape(e * cap, d)
    contrib = torch.where(keep[:, None],
                          dist.take_rows(ye, torch.clamp_max(slot,
                                                             e * cap - 1))
                          * sorted_gate[:, None].to(xt.dtype), 0.0)
    return torch.zeros((n, d), dtype=xt.dtype, device=dev).index_add(
        0, sorted_token, contrib)
