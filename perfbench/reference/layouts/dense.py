"""The dense family: a pre-norm decoder layer, GQA attention and a SwiGLU
MLP, no biases, an untied head."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.nn.functional as F

from perfbench.reference import model as M


def leaf_shapes(cfg) -> Dict[str, Tuple[tuple, str]]:
    """Path -> (shape, dtype name): the embedding, the final norm, the head
    and the attention and norms stacked over the layers, and with
    ``mlp=True`` the MLP's three projections."""
    return _shapes(cfg, mlp=True)


def _shapes(cfg, mlp: bool) -> Dict[str, Tuple[tuple, str]]:
    if cfg["qkv_bias"] or cfg["tied_embeddings"] or cfg["act"] != "swiglu":
        raise ValueError(f"perfbench layout: unsupported {cfg}")
    d, f, v, nl = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    hd = M.head_dim(cfg)
    h, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    pdt = cfg["param_dtype"]
    out = {"embed.table": ((v, d), pdt),
           "final_norm.scale": ((d,), pdt),
           "lm_head": ((d, v), pdt),
           "layers.norm1.scale": ((nl, d), pdt),
           "layers.norm2.scale": ((nl, d), pdt),
           "layers.attn.wq": ((nl, d, h), pdt),
           "layers.attn.wk": ((nl, d, kv), pdt),
           "layers.attn.wv": ((nl, d, kv), pdt),
           "layers.attn.wo": ((nl, h, d), pdt)}
    if mlp:
        out.update({"layers.mlp.wg": ((nl, d, f), pdt),
                    "layers.mlp.wu": ((nl, d, f), pdt),
                    "layers.mlp.wd": ((nl, f, d), pdt)})
    return out


def init_scale(cfg, path: str) -> Optional[float]:
    """The program's initialisation: norms at one, the embedding at unit
    scale, the down projections at ``d_ff ** -0.5``, the rest at
    ``d_model ** -0.5``."""
    if path.endswith("scale"):
        return None
    if path == "embed.table":
        return 1.0
    if path.endswith(".wd"):
        return cfg["d_ff"] ** -0.5
    return cfg["d_model"] ** -0.5


def mlp(cfg, w: M.Leaves, l: int, h, groups, fp8: bool,
        stats: Optional[dict] = None):
    g = F.silu(M.mm(h, w["layers.mlp.wg"][l], fp8))
    u = M.mm(h, w["layers.mlp.wu"][l], fp8)
    return M.mm(g * u, w["layers.mlp.wd"][l], fp8), h.new_zeros(())


def layer(cfg, w, l, x, pos, attend, groups, fp8, stats=None):
    return M.decoder_layer(cfg, w, l, x, pos, attend, mlp, groups, fp8,
                           stats)
