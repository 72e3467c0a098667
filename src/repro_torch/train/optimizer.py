"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).

Counterpart of ``repro/train/optimizer.py``: functions on a dict tree of
tensors, leaves in the reference's order, with the reference's arithmetic
in its order.  The reference's step is one ``jax.jit``, where XLA may
contract a multiply-add into an FMA; the port's eager ops round each
operation, so training arithmetic is held to the reference within a stated
tolerance, not bit for bit.

Unlike the reference, the update writes the optimizer state in place (each
leaf's new moments are computed out of place, then copied into the state's
tensors): at internlm2-1.8b's width the fp32 moments are 15 GB, and a
second copy of them at every step is what in-place saves.  The returned
``OptState`` holds the same tensors; the parameters come back as new
tensors, as in the reference.

``adamw_update`` is one ``repro_torch.adamw`` span (``repro_torch.spans``)
a call, recording each leaf's size and the parameter's and the gradient's
dtypes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import spans
from repro_torch.train.pytree import flatten_with_paths, tree_leaves, \
    tree_map, tree_unflatten_like

Pytree = Any


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    inner: Pytree


def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) * g.to(torch.float32))
                        for g in leaves))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _step(state: OptState) -> Tuple[torch.Tensor, torch.Tensor]:
    step = state.step + 1
    return step, step.to(torch.float32)


def _node(tree: Pytree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ AdamW --

def adamw_init(params: Pytree) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
        inner={"m": tree_map(_zeros_f32, params),
               "v": tree_map(_zeros_f32, params)})


def adamw_update(params: Pytree, grads: Pytree, state: OptState,
                 lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.01
                 ) -> Tuple[Pytree, OptState]:
    def sizes():
        return [(p.numel(), p.dtype, g.dtype) for p, g in
                zip(tree_leaves(params), tree_leaves(grads))]

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        update = (m / c1) / (torch.sqrt(v / c2) + eps) \
            + wd * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype)

    with torch.no_grad(), spans.span("adamw", leaves=sizes):
        step, t = _step(state)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        new_params = tree_map(upd, params, grads, state.inner["m"],
                              state.inner["v"])
    return new_params, OptState(step=step, inner=state.inner)


# -------------------------------------------------------------- Adafactor --

def adafactor_init(params: Pytree) -> OptState:
    def per_leaf(p):
        if p.dim() >= 2:
            return {"vr": _zeros_f32(p, p.shape[:-1]),
                    "vc": _zeros_f32(p, p.shape[:-2] + p.shape[-1:])}
        return {"v": _zeros_f32(p)}
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device),
                    inner=tree_map(per_leaf, params))


def adafactor_update(params: Pytree, grads: Pytree, state: OptState,
                     lr: float, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0
                     ) -> Tuple[Pytree, OptState]:
    step, t = _step(state)
    beta = 1.0 - t ** (-decay)

    def upd(p, g, s):
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + eps
        if p.dim() >= 2:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * torch.mean(g2, -1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * torch.mean(g2, -2))
            vr, vc = s["vr"], s["vc"]
            rfac = torch.rsqrt(
                vr / torch.clamp_min(torch.mean(vr, -1, keepdim=True), eps))
            cfac = torch.rsqrt(vc)
            update = g32 * rfac[..., :, None] * cfac[..., None, :]
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            update = g32 * torch.rsqrt(s["v"])
        # relative update clipping (Adafactor's RMS clip)
        rms = torch.sqrt(torch.mean(update * update) + eps)
        update = update / torch.clamp_min(rms / clip_threshold, 1.0)
        return (p.to(torch.float32) - lr * update).to(p.dtype)

    with torch.no_grad():
        new = [upd(p, g, _node(state.inner, path)) for (path, p), g in
               zip(flatten_with_paths(params), tree_leaves(grads))]
    return tree_unflatten_like(params, new), OptState(step=step,
                                                      inner=state.inner)


def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
