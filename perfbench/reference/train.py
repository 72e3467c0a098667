"""The reference's first training steps: the plain model's loss and
gradients (autograd, each layer recomputed in the backward), the top-k
bitplane compressor with error feedback (exponent ``ceil(log2(amax))``,
scale ``2 ** e``, codes ``round(x / scale · 2^k)``), the clip to a global
norm, and AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.01), in
float32 from the run's seed.

It reports what the program's run is held to: each step's loss, each
leaf's norm of the first step's gradient as the optimizer gets it (after
the compressor and the clip), and each leaf's norm of the change of the
parameters over the steps.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference import model as M
from perfbench.reference.decode import reference_leaves
from perfbench.weights import make_leaf


def compress(g: torch.Tensor, fb: torch.Tensor, k: int) -> torch.Tensor:
    """g + fb quantised to ``k`` bitplanes under a power-of-two scale and
    dequantised; ``fb`` takes the residual."""
    corrected = g + fb
    amax = corrected.abs().max()
    scale = torch.exp2(torch.ceil(torch.log2(amax.clamp_min(1e-30))))
    deq = torch.round(corrected / scale * 2.0 ** k) * (scale / 2.0 ** k)
    fb.copy_(corrected - deq)
    return deq


def run(cfg, job, seed: int, batches: List[Dict[str, torch.Tensor]],
        device, fp8: bool = False, keep_first: bool = False,
        against: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        ) -> Dict[str, object]:
    """``len(batches)`` steps from the seed's weights.  With
    ``keep_first``, the first step's gradients as the optimizer gets them
    come back on the host in bfloat16 (``first``); for each named tree of
    such gradients in ``against``, each leaf's norm of its difference from
    this run's comes back under ``diff``."""
    M.no_tf32()
    w = reference_leaves(cfg, seed, device)
    paths = list(w)
    for t in w.values():
        t.requires_grad_(True)
    m = {p: torch.zeros_like(w[p]) for p in paths}
    v = {p: torch.zeros_like(w[p]) for p in paths}
    fb = {p: torch.zeros_like(w[p]) for p in paths}
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.01
    lr, k = job["lr"], job["k_planes"]
    losses, first_grad, first = [], {}, {}
    diff: Dict[str, Dict[str, float]] = {name: {} for name in against or {}}
    for step, batch in enumerate(batches, start=1):
        loss = M.train_loss(cfg, w, batch, fp8, checkpoint)
        grads = torch.autograd.grad(loss, [w[p] for p in paths])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {p: compress(gr, fb[p], k) for p, gr in zip(paths, grads)}
            del grads
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            scale = torch.clamp_max(job["max_grad_norm"]
                                    / torch.clamp_min(norm, 1e-12), 1.0)
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for p in paths:
                gp = g.pop(p) * scale
                if step == 1:
                    first_grad[p] = float(torch.linalg.vector_norm(gp))
                    for name, tree in (against or {}).items():
                        other = tree[p].to(device, torch.float32)
                        diff[name][p] = float(
                            torch.linalg.vector_norm(gp - other))
                        del other
                    if keep_first:
                        first[p] = gp.to(torch.bfloat16).cpu()
                m[p].mul_(b1).add_(gp, alpha=1 - b1)
                v[p].mul_(b2).add_(gp * gp, alpha=1 - b2)
                upd = (m[p] / c1) / (torch.sqrt(v[p] / c2) + eps) \
                    + wd * w[p]
                w[p].sub_(lr * upd)
    del m, v, fb
    change = {}
    with torch.no_grad():
        for p in paths:
            start = make_leaf(cfg, seed, p, device).to(torch.float32)
            change[p] = float(torch.linalg.vector_norm(w[p] - start))
    return {"loss": losses, "grad": first_grad, "change": change,
            "first": first, "diff": diff}
