"""The moe family: the dense family's attention, and in place of its MLP
a top-k mixture of SwiGLU experts with capacity-bounded dispatch and a
float32 router.

The router's softmax, its top-k renormalised, each (token, slot) pair
queued on its expert in token-major order within a group and dropped past
the capacity ``ceil8(int(1.25 · n · k / E))`` (at least 8), and the Switch
auxiliary loss."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import model as M
from perfbench.reference.layouts import dense

init_scale = dense.init_scale


def leaf_shapes(cfg) -> Dict[str, Tuple[tuple, str]]:
    out = dense._shapes(cfg, mlp=False)
    d, f, nl, e = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], \
        cfg["n_experts"]
    pdt = cfg["param_dtype"]
    out.update({"layers.moe.router": ((nl, d, e), "float32"),
                "layers.moe.wg": ((nl, e, d, f), pdt),
                "layers.moe.wu": ((nl, e, d, f), pdt),
                "layers.moe.wd": ((nl, e, f, d), pdt)})
    return out


def capacity(cfg, n_tokens: int) -> int:
    cap = int(cfg["capacity_factor"] * n_tokens * cfg["top_k"]
              / cfg["n_experts"])
    if cap % 8:
        cap += 8 - cap % 8
    return max(cap, 8)


def route(cfg, w: M.Leaves, l: int, xg: torch.Tensor, fp8: bool,
          stats: Optional[dict] = None):
    """xg (G, n, D): G groups of n tokens, each group routed and queued on
    its own, as one call of the MoE layer routes its tokens.  Returns
    (output (G, n, D), the auxiliary loss over every token); counts the
    (token, slot) pairs and those dropped into ``stats``."""
    gn, n, d = xg.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    xt = xg.reshape(gn * n, d)
    probs = torch.softmax(M.mm(xt, w["layers.moe.router"][l], fp8), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True)
    top1 = F.one_hot(idx[:, 0], e).to(torch.float32)
    aux = float(e) * torch.sum(probs.mean(0) * top1.mean(0))
    pairs = idx.reshape(gn, n * k)
    onehot = F.one_hot(pairs, e)
    pos = torch.gather(torch.cumsum(onehot, 1) - onehot, 2,
                       pairs[..., None])[..., 0]
    keep = (pos < capacity(cfg, n)).reshape(-1)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + keep.numel()
        stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
    flat_e, flat_g = idx.reshape(-1), gates.reshape(-1)
    token = torch.arange(gn * n, device=xg.device).repeat_interleave(k)
    out = torch.zeros_like(xt)
    for ex in range(e):
        sel = torch.nonzero((flat_e == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        t = token[sel]
        xe = xt[t]
        y = M.mm(F.silu(M.mm(xe, w["layers.moe.wg"][l][ex], fp8))
                 * M.mm(xe, w["layers.moe.wu"][l][ex], fp8),
                 w["layers.moe.wd"][l][ex], fp8)
        out = out.index_add(0, t, y * flat_g[sel, None])
    return out.reshape(gn, n, d), aux


def experts(cfg, w, l, h, groups, fp8, stats=None):
    y, aux = route(cfg, w, l, groups(h), fp8, stats)
    return groups.inverse(y, h.shape), aux


def layer(cfg, w, l, x, pos, attend, groups, fp8, stats=None):
    return M.decoder_layer(cfg, w, l, x, pos, attend, experts, groups, fp8,
                           stats)
