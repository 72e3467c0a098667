"""Train step builder.

Counterpart of ``repro/train/train_step.py::make_train_step``: returns
``(opt_init, train_step)`` where ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` over a parameter tree of tensors.  The
reference's step is one ``jax.jit``; the port's is eager autograd (no
``torch.compile``).  ``make_serve_step`` returns ``serve_step(params,
state, token) -> (logits, state)``, the reference's: one
``transformer.decode_step``, which runs under ``torch.no_grad()`` and
updates the decode state in place (the state passed in is consumed).

Each step is a root span (``repro_torch.serve_step``,
``repro_torch.train_step``; ``repro_torch.spans``), live only under a
profiler.

Optional hook ``grad_transform``: applied to the gradient tree before
clipping (bitplane gradient compression with error feedback plugs in
here, see ``train/grad_compress.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import clip_by_global_norm, make_optimizer
from repro_torch.train.pytree import tree_leaves, tree_unflatten_like

Pytree = Any


def value_and_grad(cfg: ModelConfig, params: Pytree,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Pytree]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics,
    grads) with the gradient tree in ``params``' structure.  ``params``
    may be ``nn.Parameter``s (their ``.grad`` is left alone) or plain
    tensors."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten_like(params, leaves)
    loss, metrics = T.loss_fn(tree, cfg, batch)
    # a leaf the loss does not read (an SSD block's norm2) gets zeros, as
    # under jax.grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten_like(params, list(grads)))


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    max_grad_norm: float = 1.0,
                    grad_transform: Optional[Callable] = None):
    opt_init, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params: Pytree, opt_state, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Pytree, Any, Dict[str, torch.Tensor]]:
        b, s = batch["tokens"].shape
        with spans.span("train_step", batch=b, seq=s):
            loss, metrics, grads = value_and_grad(cfg, params, batch)
            if grad_transform is not None:
                grads = grad_transform(grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            params, opt_state = opt_update(params, grads, opt_state, lr=lr)
        out = {"loss": loss, "grad_norm": gnorm, **metrics}
        return params, opt_state, out

    return opt_init, train_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params: Pytree, state: Dict[str, torch.Tensor],
                   token: torch.Tensor):
        with spans.span("serve_step", batch=token.shape[0]):
            return T.decode_step(params, cfg, state, token)
    return serve_step
