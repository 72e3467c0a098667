"""Model assembly for every family: parameters, the training forward and
loss, and the single-token decode step with its KV-cache / SSM state.

Counterpart of ``repro/models/transformer.py`` for all six families:

  dense   pre-norm GQA transformer (gemma3/qwen2.5/internlm2/glm4)
  moe     dense attention + top-k MoE FFN (llama4-maverick, olmoe)
  ssm     Mamba2 / SSD stack (mamba2-780m)
  hybrid  Mamba2 backbone + a shared attention block every K layers (zamba2)
  encdec  encoder-decoder with cross attention (seamless-m4t; audio frontend
          stubbed as precomputed frame embeddings)
  vlm     dense decoder with prepended patch embeddings (phi-3-vision; CLIP
          frontend stubbed)

``init_decode_state`` gives each family's state with the reference's keys,
shapes and dtypes (an int8 cache with float32 per-token-per-head scales
for dense, moe and vlm when ``cfg.kv_cache_dtype == "int8"``; ``pos`` a 0-d
int32 tensor on the device).  ``decode_step`` consumes the state it is
given: it writes the step's K/V (and scales), conv and SSM states into the
state's own tensors, in place, and returns a dict of those tensors with
``pos`` advanced, where the reference's functional update builds new arrays (a
second copy of a full-size cache does not fit the card).  A caller that
needs the state before the step copies it first.  A step at ``pos >=
max_seq`` writes the last slot (``dynamic_update_slice`` clamps its start
index) and attends to every slot, as in the reference.  The step reads
nothing back to the host.

Parameters keep the reference's layer-stacked tree: one tensor per stacked
leaf, ``(n_layers, ...)`` (``(n_layers, E, D, F)`` for the experts), so a
checkpoint's leaves, their order and their bytes are the reference's.
:class:`Transformer` holds them as one ``nn.Parameter`` each, named by its
path (``layers.attn.wq``, ``layers.moe.wg``, ``shared.fuse``,
``encoder.layers.attn.wq`` ...), and :func:`forward` / :func:`loss_fn` are
plain functions on the tree.  Leaves named in ``FLOAT32_LEAVES`` (the MoE
router, the SSD's ``a_log``, ``dt_bias``, ``d_skip``) are float32 whatever
``cfg.param_dtype``, as the reference's init makes them.

The reference scans each stack (``lax.scan``, with ``jax.checkpoint`` when
``cfg.remat``); here the loop is unrolled.  Each stacked parameter is
unbound once per forward (the backward of ``unbind`` is one ``stack``;
indexing per layer would allocate the whole stacked gradient once per
layer), and ``cfg.remat`` wraps exactly the bodies the reference's
``jax.checkpoint`` wraps (a layer of ``_stack``, of the encoder and of the
cross-attention decoder) in ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``; the hybrid's shared block is not wrapped.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DTYPES, DeviceLike, resolve_device
from repro_torch.models import dist
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.train.pytree import flatten_with_paths, tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]

# leaves the reference's init makes float32 in any model (moe.py's router,
# ssm.py's a_log, dt_bias, d_skip)
FLOAT32_LEAVES = ("router", "a_log", "dt_bias", "d_skip")


def leaf_dtype(cfg: ModelConfig, path: Tuple[str, ...]) -> torch.dtype:
    """The dtype of the parameter at ``path`` in ``cfg``'s tree."""
    return torch.float32 if path[-1] in FLOAT32_LEAVES else \
        DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device) -> Params:
    """One block's params (unstacked): an SSD block for ssm and hybrid,
    attention plus an MoE or MLP otherwise."""
    p = {"norm1": L.init_rmsnorm(cfg.d_model, cfg, device),
         "norm2": L.init_rmsnorm(cfg.d_model, cfg, device)}
    if cfg.family in ("ssm", "hybrid"):
        p["ssd"] = S.init_ssd(gen, cfg, device)
        return p
    p["attn"] = L.init_attention(gen, cfg, device)
    if cfg.family == "moe":
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _stacked(blocks: List[Params]) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def _init_cross_block(gen: torch.Generator, cfg: ModelConfig,
                      device: torch.device) -> Params:
    return {"norm1": L.init_rmsnorm(cfg.d_model, cfg, device),
            "norm2": L.init_rmsnorm(cfg.d_model, cfg, device),
            "norm3": L.init_rmsnorm(cfg.d_model, cfg, device),
            "attn": L.init_attention(gen, cfg, device),
            "cross": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def _square(gen: torch.Generator, cfg: ModelConfig, rows: int,
            device: torch.device) -> Tensor:
    """A (rows, d_model) projection at the reference's scale."""
    return L._normal(gen, (rows, cfg.d_model), cfg, device) * rows ** -0.5


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """The reference's parameter tree with its distributions (normal times
    the same scales, ones for norms and ``d_skip``, zeros for biases, the
    reference's ``a_log``), drawn from ``generator`` (default: seed 0 on
    ``device``).  The random values are not the reference's (jax's
    threefry is not reproduced): ``convert`` carries the reference's values
    across."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    params: Params = {"embed": L.init_embedding(gen, cfg, dev),
                      "final_norm": L.init_rmsnorm(cfg.d_model, cfg, dev)}
    if not cfg.tied_embeddings:
        params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab), cfg,
                                      dev) * cfg.d_model ** -0.5
    if cfg.family == "encdec":
        enc = cfg.replace(family="dense")
        params["encoder"] = {
            "layers": _stacked([_init_block(gen, enc, dev)
                                for _ in range(cfg.n_encoder_layers)]),
            "final_norm": L.init_rmsnorm(cfg.d_model, cfg, dev)}
        params["layers"] = _stacked([_init_cross_block(gen, cfg, dev)
                                     for _ in range(cfg.n_layers)])
        params["frame_proj"] = _square(gen, cfg, cfg.d_model, dev)
        return params
    params["layers"] = _stacked([_init_block(gen, cfg, dev)
                                 for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        d = cfg.d_model
        params["shared"] = {
            "norm1": L.init_rmsnorm(d, cfg, dev),
            "norm2": L.init_rmsnorm(d, cfg, dev),
            "attn": L.init_attention(gen, cfg, dev),
            "mlp": L.init_mlp(gen, cfg, dev),
            # Zamba2: shared-block input = Linear(concat(h, embeddings))
            "fuse": _square(gen, cfg, 2 * d, dev)}
    if cfg.family == "vlm":
        # projection of precomputed patch embeddings into d_model
        params["patch_proj"] = _square(gen, cfg, cfg.d_model, dev)
    if cfg.frontend == "frames":
        params["frame_proj"] = _square(gen, cfg, cfg.d_model, dev)
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
    """A model of any family: the parameter tree as ``nn.Parameter`` leaves
    named by their paths, and ``forward(batch)`` / ``loss(batch)`` over
    it."""

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
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


def n_shared_applications(cfg: ModelConfig) -> int:
    if cfg.shared_attn_period <= 0:
        return 0
    return cfg.n_layers // cfg.shared_attn_period


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def _zero(device: torch.device) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _dense_block(bp: Params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                 inv_freq: Tensor, is_local: bool) -> Tuple[Tensor, Tensor]:
    """A pre-norm attention block with an MLP, or with an MoE whose aux loss
    it returns (0 otherwise)."""
    h = x + L.attention(bp["attn"], cfg, L.rmsnorm(bp["norm1"], x),
                        positions, inv_freq, is_local)
    if cfg.family == "moe":
        y, aux = M.moe_block(bp["moe"], cfg, L.rmsnorm(bp["norm2"], h),
                             dispatch=cfg.moe_dispatch)
        return h + y, aux
    return (h + L.mlp(bp["mlp"], cfg, L.rmsnorm(bp["norm2"], h)),
            _zero(x.device))


def _ssm_block(bp: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    return x + S.ssd_block(bp["ssd"], cfg, L.rmsnorm(bp["norm1"], x))


def _shared_attn(sp: Params, cfg: ModelConfig, x: Tensor, x0: Tensor,
                 positions: Tensor, inv_freq: Tensor) -> Tensor:
    fused = L.batch_only(L.batch_only(torch.cat([x, x0], dim=-1))
                         @ sp["fuse"].to(x.dtype))
    h = fused + L.attention(sp["attn"], cfg, L.rmsnorm(sp["norm1"], fused),
                            positions, inv_freq, False)
    return x + h + L.mlp(sp["mlp"], cfg, L.rmsnorm(sp["norm2"], h))


def _unbind_layers(tree: Params, n: int) -> List[Params]:
    """Per-layer views of a stacked tree, each leaf unbound once."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _run(cfg: ModelConfig, body, *args):
    """``body(*args)``, under activation checkpointing when ``cfg.remat``
    (the reference's ``jax.checkpoint`` of a scan body)."""
    if cfg.remat:
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _stack(cfg: ModelConfig, params: Params, x: Tensor,
           positions: Tensor) -> Tuple[Tensor, Tensor]:
    """Run the layer stack. Returns (hidden, aux_loss_sum).  The hybrid
    runs ``shared_attn_period`` Mamba2 layers, then the shared block, per
    group, and the layers left over (``n_layers % period``) last."""
    inv_freq = L.rope_frequencies(cfg, x.device)
    is_local = layer_flags(cfg)["is_local"]
    blocks = _unbind_layers(params["layers"], cfg.n_layers)
    aux = _zero(x.device)
    if cfg.family in ("ssm", "hybrid"):
        h, x0 = x, x
        period = cfg.shared_attn_period
        for i, bp in enumerate(blocks):
            h = _run(cfg, _ssm_block, bp, cfg, h)
            if cfg.family == "hybrid" and (i + 1) % period == 0:
                h = _shared_attn(params["shared"], cfg, h, x0, positions,
                                 inv_freq)
        return h, aux
    # sequence-parallel residual stream: the layer boundary (what remat
    # saves) seq-sharded over "model", only with batch-parallel attention
    seq_parallel_carry = (
        cfg.attn_param_replication and dist.axis_size("model") > 1
        and cfg.n_kv_heads % dist.axis_size("model") != 0)
    h = x
    for i, bp in enumerate(blocks):
        h, a = _run(cfg, _dense_block, bp, cfg, h, positions, inv_freq,
                    bool(is_local[i]))
        if seq_parallel_carry:
            h = dist.hint(h, None, "model", None)
        aux = aux + a
    return h, aux


def _encoder_stack(cfg: ModelConfig, params: Params, frames: Tensor
                   ) -> Tensor:
    """Bidirectional encoder over precomputed frame embeddings (stub
    frontend): frames (B, T, D)."""
    enc_cfg = cfg.replace(family="dense")
    x = L.batch_only(L.batch_only(frames)
                     @ params["frame_proj"].to(frames.dtype))
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(b, t)
    inv_freq = L.rope_frequencies(enc_cfg, x.device)

    def body(bp, h):
        hh = h + L.attention_bidir(bp["attn"], enc_cfg,
                                   L.rmsnorm(bp["norm1"], h), positions,
                                   inv_freq)
        return hh + L.mlp(bp["mlp"], enc_cfg, L.rmsnorm(bp["norm2"], hh))

    h = x
    for bp in _unbind_layers(params["encoder"]["layers"],
                             cfg.n_encoder_layers):
        h = _run(cfg, body, bp, h)
    return L.rmsnorm(params["encoder"]["final_norm"], h)


def _decoder_stack_cross(cfg: ModelConfig, params: Params, x: Tensor,
                         enc_out: Tensor, positions: Tensor) -> Tensor:
    inv_freq = L.rope_frequencies(cfg, x.device)
    b, t_enc = enc_out.shape[0], enc_out.shape[1]
    enc_pos = torch.arange(t_enc, dtype=torch.int32,
                           device=x.device).expand(b, t_enc)

    def body(bp, h, enc_out):
        hh = h + L.attention(bp["attn"], cfg, L.rmsnorm(bp["norm1"], h),
                             positions, inv_freq, False)
        hh = hh + L.cross_attention(bp["cross"], cfg,
                                    L.rmsnorm(bp["norm2"], hh), enc_out,
                                    positions, enc_pos, inv_freq)
        return hh + L.mlp(bp["mlp"], cfg, L.rmsnorm(bp["norm3"], hh))

    h = x
    for bp in _unbind_layers(params["layers"], cfg.n_layers):
        h = _run(cfg, body, bp, h, enc_out)
    return h


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """-> (logits (B,S,V) over the *text* positions, aux_loss)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], cfg, tokens)
    aux = _zero(tokens.device)
    if cfg.family == "encdec":
        enc_out = _encoder_stack(cfg, params, batch["frames"])
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        h = _decoder_stack_cross(cfg, params, x, enc_out, positions)
    elif cfg.family == "vlm":
        patches = L.batch_only(L.batch_only(batch["patches"])
                               @ params["patch_proj"].to(x.dtype))
        x = torch.cat([patches, x], dim=1)
        st = x.shape[1]
        positions = torch.arange(st, dtype=torch.int32,
                                 device=tokens.device).expand(b, st)
        h, aux = _stack(cfg, params, x, positions)
        h = h[:, patches.shape[1]:, :]   # logits over text positions only
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        h, aux = _stack(cfg, params, x, positions)
    h = L.rmsnorm(params["final_norm"], h)
    logits = L.unembed(params["embed"], params.get("lm_head"), cfg, h)
    return logits, aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean next-token cross entropy over positions with a label >= 0 (the
    last position's label is -1), plus 0.01 of the MoE aux loss.
    ``torch.gather`` refuses -1, where the reference's ``take_along_axis``
    wraps it: the index is clamped to 0 and the mask zeroes the term either
    way."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp_min(0).to(torch.int64).unsqueeze(-1)
    # on vocabulary-sharded logits the gather is a partial sum over the
    # vocabulary's shards, reduced here while it is still 3-D
    gold = dist.hint(dist.gather_last(logits, idx), None, None,
                     dist.REP).squeeze(-1)
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    ce = torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (single token with cache)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype: Optional[str] = None,
                      device: DeviceLike = None) -> Dict[str, Tensor]:
    """The decode state of ``cfg``'s family, zeros, on ``device`` (default
    CUDA): the reference's keys, shapes and dtypes (``dtype`` defaults to
    ``cfg.dtype``).  encdec's ``enc_out`` (the cached encoder output) is
    the caller's to fill."""
    dev = resolve_device(device)
    dt = DTYPES[dtype or cfg.dtype]
    kv, hd = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state: Dict[str, Tensor] = {"pos": zeros((), torch.int32)}
    cache = (batch, max_seq, kv, hd)
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.kv_cache_dtype == "int8":
            state["k"] = zeros((cfg.n_layers,) + cache, torch.int8)
            state["v"] = zeros((cfg.n_layers,) + cache, torch.int8)
            state["k_scale"] = zeros((cfg.n_layers,) + cache[:3],
                                     torch.float32)
            state["v_scale"] = zeros((cfg.n_layers,) + cache[:3],
                                     torch.float32)
        else:
            state["k"] = zeros((cfg.n_layers,) + cache)
            state["v"] = zeros((cfg.n_layers,) + cache)
    elif cfg.family in ("ssm", "hybrid"):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        state["conv"] = zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                               conv_dim))
        state["ssm"] = zeros((cfg.n_layers, batch, cfg.ssm_heads,
                              cfg.ssm_state, cfg.ssm_headdim))
        if cfg.family == "hybrid":
            napp = n_shared_applications(cfg)
            state["k"] = zeros((napp,) + cache)
            state["v"] = zeros((napp,) + cache)
            state["x0"] = zeros((batch, 1, cfg.d_model))
    elif cfg.family == "encdec":
        state["k"] = zeros((cfg.n_layers,) + cache)
        state["v"] = zeros((cfg.n_layers,) + cache)
        # cached encoder output for cross-attention
        state["enc_out"] = zeros((batch, max_seq, cfg.d_model))
    else:
        raise ValueError(cfg.family)
    return state


def _ssm_decode_layer(bp: Params, cfg: ModelConfig, h: Tensor,
                      state: Dict[str, Tensor], i: int) -> Tensor:
    """Layer ``i``'s Mamba2 block on one token; its conv and SSM states are
    written into ``state`` in place."""
    y, nc, ns = S.ssd_decode(bp["ssd"], cfg, L.rmsnorm(bp["norm1"], h),
                             state["conv"][i], state["ssm"][i])
    state["conv"][i].copy_(nc)
    state["ssm"][i].copy_(ns)
    return h + y


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, state: Dict[str, Tensor],
                token: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """token: (B, 1) int32 -> (logits (B, 1, V), state).  The state is
    consumed: its tensors are updated in place and the returned dict holds
    them with ``pos`` advanced (see the module's note).  Runs under
    ``torch.no_grad()``, so ``nn.Parameter`` leaves build no graph over the
    cache."""
    dev = token.device
    inv_freq = L.rope_frequencies(cfg, dev)
    is_local = layer_flags(cfg)["is_local"]
    x = L.embed(params["embed"], cfg, token)
    pos = state["pos"]
    blocks = _unbind_layers(params["layers"], cfg.n_layers)

    if cfg.family in ("dense", "moe", "vlm"):
        q8 = cfg.kv_cache_dtype == "int8"
        h = x
        for i, bp in enumerate(blocks):
            scales = (state["k_scale"][i], state["v_scale"][i]) if q8 \
                else None
            h = h + L.attention_decode(
                bp["attn"], cfg, L.rmsnorm(bp["norm1"], h), state["k"][i],
                state["v"][i], pos, inv_freq, bool(is_local[i]), scales)
            if cfg.family == "moe":
                y, _ = M.moe_block(bp["moe"], cfg, L.rmsnorm(bp["norm2"], h),
                                   dispatch=cfg.moe_dispatch)
                h = h + y
            else:
                h = h + L.mlp(bp["mlp"], cfg, L.rmsnorm(bp["norm2"], h))

    elif cfg.family == "ssm":
        h = x
        for i, bp in enumerate(blocks):
            h = _ssm_decode_layer(bp, cfg, h, state, i)

    elif cfg.family == "hybrid":
        # groups of ``period`` Mamba2 layers, each followed by the shared
        # block (its cache at index g), then the layers left over
        shared = params["shared"]
        period = cfg.shared_attn_period
        h, x0 = x, x
        for i, bp in enumerate(blocks):
            h = _ssm_decode_layer(bp, cfg, h, state, i)
            if (i + 1) % period == 0:
                g = (i + 1) // period - 1
                fused = L.batch_only(torch.cat([h, x0], dim=-1)) \
                    @ shared["fuse"].to(h.dtype)
                a = L.attention_decode(
                    shared["attn"], cfg, L.rmsnorm(shared["norm1"], fused),
                    state["k"][g], state["v"][g], pos, inv_freq, False)
                hh = fused + a
                h = h + hh + L.mlp(shared["mlp"], cfg,
                                   L.rmsnorm(shared["norm2"], hh))

    elif cfg.family == "encdec":
        enc_out = state["enc_out"]
        b, t_enc = enc_out.shape[0], enc_out.shape[1]
        enc_pos = torch.arange(t_enc, dtype=torch.int32,
                               device=dev).expand(b, t_enc)
        h = x
        for i, bp in enumerate(blocks):
            h = h + L.attention_decode(
                bp["attn"], cfg, L.rmsnorm(bp["norm1"], h), state["k"][i],
                state["v"][i], pos, inv_freq, False)
            h = h + L.cross_attention(bp["cross"], cfg,
                                      L.rmsnorm(bp["norm2"], h), enc_out,
                                      pos.expand(b, 1), enc_pos, inv_freq)
            h = h + L.mlp(bp["mlp"], cfg, L.rmsnorm(bp["norm3"], h))
    else:
        raise ValueError(cfg.family)

    h = L.rmsnorm(params["final_norm"], h)
    logits = L.unembed(params["embed"], params.get("lm_head"), cfg, h)
    return logits, dict(state, pos=pos + 1)
