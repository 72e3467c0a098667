"""The reference over served requests: for each epoch of a decode cell
(a batch of requests that start at the context's end), run the plain
model over every input token that was fed, against the context drawn
again from the seed, and read at each position the gap by which a token's
logit lies below the reference's best.

It runs layer by layer, so one layer's context is in memory at a time,
and every epoch's positions at once within a layer, attention in blocks
of rows.  A decode step routes the batch's tokens as one group, so the
MoE queues each step's tokens on their own, in row order, as the program
does.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench import traffic
from perfbench.reference import layouts
from perfbench.reference import model as M
from perfbench.weights import leaf_shapes, make_leaf

# bytes of float32 scores a block of rows may take
_SCORE_BYTES = 1.5e9


def reference_leaves(cfg, seed: int, device) -> M.Leaves:
    """The run's weights drawn again from its seed, in float32."""
    return {p: make_leaf(cfg, seed, p, device).to(torch.float32)
            for p in leaf_shapes(cfg)}


def epoch_logits(cfg, wl, seed: int, w: M.Leaves,
                 inputs: List[torch.Tensor], fp8: bool, device,
                 stats: Optional[dict] = None):
    """Yield (epoch, row block, logits (b, n, V)) for each epoch's inputs
    (B, n_e) int64 on the device."""
    c = wl["context"]
    fam = layouts.of(cfg)
    xs = [M.embed(w, t) for t in inputs]
    groups = M.Groups("step")
    for l in range(cfg["n_layers"]):
        kc = traffic.context_block(cfg, wl, seed, l, "k", device).float()
        vc = traffic.context_block(cfg, wl, seed, l, "v", device).float()

        def attend(q, k, v):
            n = q.shape[1]
            per_row = cfg["n_heads"] * n * (c + n) * 4
            rows = max(1, int(_SCORE_BYTES // per_row))
            return torch.cat([
                M.context_attention(q[i:i + rows], k[i:i + rows],
                                    v[i:i + rows], kc[i:i + rows],
                                    vc[i:i + rows], fp8)
                for i in range(0, q.shape[0], rows)])

        for e, x in enumerate(xs):
            pos = c + torch.arange(x.shape[1], device=device)
            xs[e], _ = fam.layer(cfg, w, l, x, pos, attend, groups, fp8,
                                 stats)
        del kc, vc
    for e, x in enumerate(xs):
        rows = max(1, int(_SCORE_BYTES // (x.shape[1] * cfg["vocab"] * 4)))
        for i in range(0, x.shape[0], rows):
            yield e, slice(i, i + rows), M.logits_of(cfg, w, x[i:i + rows],
                                                     fp8)


@torch.no_grad()
def gaps(cfg, wl, seed: int, inputs: List[torch.Tensor],
         served: List[torch.Tensor], device,
         control: Optional[List[torch.Tensor]] = None) -> Dict[str, float]:
    """The gaps of the served tokens (and of ``control``'s tokens, when
    given) below the reference's best logit, over every position of every
    epoch: the widest (``gap``), the mean (``gap_mean``) and quantiles;
    tensors (B, n_e) int64 on the device."""
    M.no_tf32()
    w = reference_leaves(cfg, seed, device)
    every = {"served": [], "control": []}
    stats: dict = {}
    for e, rows, logits in epoch_logits(cfg, wl, seed, w, inputs, False,
                                        device, stats):
        best = logits.max(-1).values
        for name, toks in (("served", served), ("control", control)):
            if toks is None:
                continue
            got = torch.gather(logits, -1, toks[e][rows][..., None])[..., 0]
            every[name].append((best - got).reshape(-1).cpu())
    out = {"tokens": sum(g.numel() for g in every["served"]), **stats}
    for name, key in (("served", "gap"), ("control", "control_gap")):
        if not every[name]:
            continue
        g = torch.cat(every[name]).to(torch.float64)
        q = torch.quantile(g, torch.tensor([0.5, 0.99, 0.999],
                                            dtype=torch.float64))
        out.update({key: float(g.max()), f"{key}_mean": float(g.mean()),
                    f"{key}_p50": float(q[0]), f"{key}_p99": float(q[1]),
                    f"{key}_p999": float(q[2]),
                    f"{key}_nonzero": int((g > 0).sum())})
    return out


@torch.no_grad()
def control_tokens(cfg, wl, seed: int, inputs: List[torch.Tensor],
                   device) -> List[torch.Tensor]:
    """The token the fp8 control puts first at each position of the same
    inputs: (B, n_e) int64 per epoch."""
    M.no_tf32()
    w = reference_leaves(cfg, seed, device)
    out = [torch.empty_like(t) for t in inputs]
    for e, rows, logits in epoch_logits(cfg, wl, seed, w, inputs, True,
                                        device):
        out[e][rows] = logits.argmax(-1)
    return out
