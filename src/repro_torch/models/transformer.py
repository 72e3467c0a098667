"""Model assembly, dense family: parameters, the training forward and loss.

Counterpart of ``repro/models/transformer.py`` for ``family="dense"``
(gemma3, qwen2.5, internlm2, glm4): pre-norm GQA blocks, optional sliding
window on local layers, tied or separate unembedding.  The other families
(moe, ssm, hybrid, encdec, vlm) and the decode step come in later slices
and raise ``NotImplementedError`` when a model is built or run.

Parameters keep the reference's layer-stacked tree: one tensor per stacked
leaf, ``(n_layers, ...)``, so a checkpoint's leaves, their order and their
bytes are the reference's.  :class:`Transformer` holds them as one
``nn.Parameter`` each, named by its path (``layers.attn.wq`` ...), and
:func:`forward` / :func:`loss_fn` are plain functions on the tree.

The reference scans the stack (``lax.scan``, with ``jax.checkpoint`` when
``cfg.remat``); here the loop is unrolled.  Each stacked parameter is
unbound once per forward (the backward of ``unbind`` is one ``stack``;
indexing per layer would allocate the whole stacked gradient once per
layer), and ``cfg.remat`` wraps each block in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DTYPES, DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.train.pytree import flatten_with_paths, tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family this slice of the port does not build."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(A12, later slice); only 'dense' models run in repro_torch")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device) -> Params:
    """One transformer block's params (unstacked)."""
    return {"norm1": L.init_rmsnorm(cfg.d_model, cfg, device),
            "norm2": L.init_rmsnorm(cfg.d_model, cfg, device),
            "attn": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """The reference's parameter tree with its distributions (normal times
    the same scales, ones for norms, zeros for biases), drawn from
    ``generator`` (default: seed 0 on ``device``).  The values are not the
    reference's (jax's threefry is not reproduced): ``convert`` carries the
    reference's values across."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    params: Params = {"embed": L.init_embedding(gen, cfg, dev),
                      "final_norm": L.init_rmsnorm(cfg.d_model, cfg, dev)}
    if not cfg.tied_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, cfg.vocab), generator=gen,
            dtype=DTYPES[cfg.param_dtype],
            device=dev) * cfg.d_model ** -0.5
    blocks = [_init_block(gen, cfg, dev) for _ in range(cfg.n_layers)]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return params


# ---------------------------------------------------------------------------
# The module: one parameter per stacked leaf
# ---------------------------------------------------------------------------


class _Node(nn.Module):
    """A dict node of the parameter tree: tensors become parameters, dicts
    child nodes, each under its own key."""

    def __init__(self, tree: Params):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Params:
        return {k: getattr(self, k).tree() if isinstance(getattr(self, k),
                                                         _Node)
                else getattr(self, k) for k in self._keys}


class Transformer(nn.Module):
    """A dense model: the parameter tree as ``nn.Parameter`` leaves named by
    their paths, and ``forward(batch)`` / ``loss(batch)`` over it."""

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        require_dense(cfg)
        self.cfg = cfg
        self.params = _Node(params if params is not None
                            else init_params(cfg, generator, device))

    def tree(self) -> Params:
        """The parameter tree (the ``nn.Parameter`` objects themselves)."""
        return self.params.tree()

    def leaves(self) -> Iterator[Tuple[str, nn.Parameter]]:
        """``(path, parameter)`` in the reference's leaf order (dict keys
        sorted at every level, as ``jax.tree_util`` flattens)."""
        return ((".".join(path), p)
                for path, p in flatten_with_paths(self.tree()))

    def forward(self, batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        return forward(self.tree(), self.cfg, batch)

    def loss(self, batch: Dict[str, Tensor]):
        return loss_fn(self.tree(), self.cfg, batch)


# ---------------------------------------------------------------------------
# Layer-type metadata (local/global pattern, shared-attn positions)
# ---------------------------------------------------------------------------


def layer_flags(cfg: ModelConfig) -> Dict[str, np.ndarray]:
    idx = np.arange(cfg.n_layers)
    if cfg.local_global_period > 0:
        is_local = (idx % cfg.local_global_period) != \
            (cfg.local_global_period - 1)
    else:
        is_local = np.zeros(cfg.n_layers, bool)
    if cfg.shared_attn_period > 0:
        shared_here = (idx % cfg.shared_attn_period) == \
            (cfg.shared_attn_period - 1)
    else:
        shared_here = np.zeros(cfg.n_layers, bool)
    return {"is_local": is_local, "shared_here": shared_here,
            "shared_idx": np.cumsum(shared_here) - 1}


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def _dense_block(bp: Params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                 inv_freq: Tensor, is_local: bool) -> Tensor:
    h = x + L.attention(bp["attn"], cfg, L.rmsnorm(bp["norm1"], x),
                        positions, inv_freq, is_local)
    return h + L.mlp(bp["mlp"], cfg, L.rmsnorm(bp["norm2"], h))


def _unbind_layers(tree: Params, n: int) -> List[Params]:
    """Per-layer views of a stacked tree, each leaf unbound once."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _stack(cfg: ModelConfig, params: Params, x: Tensor,
           positions: Tensor) -> Tuple[Tensor, Tensor]:
    """Run the layer stack. Returns (hidden, aux_loss_sum); the dense
    family's aux loss is 0."""
    require_dense(cfg)
    inv_freq = L.rope_frequencies(cfg, x.device)
    is_local = layer_flags(cfg)["is_local"]
    h = x
    for i, bp in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        args = (bp, cfg, h, positions, inv_freq, bool(is_local[i]))
        if cfg.remat:
            h = checkpoint(_dense_block, *args, use_reentrant=False)
        else:
            h = _dense_block(*args)
    return h, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """-> (logits (B,S,V), aux_loss)."""
    require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    h, aux = _stack(cfg, params, x, positions)
    h = L.rmsnorm(params["final_norm"], h)
    logits = L.unembed(params["embed"], params.get("lm_head"), cfg, h)
    return logits, aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean next-token cross entropy over positions with a label >= 0 (the
    last position's label is -1).  ``torch.gather`` refuses -1, where the
    reference's ``take_along_axis`` wraps it: the index is clamped to 0 and
    the mask zeroes the term either way."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp_min(0).to(torch.int64)[..., None]
    gold = torch.gather(logits, -1, idx)[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    ce = torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}
