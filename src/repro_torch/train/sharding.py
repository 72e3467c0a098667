"""Sharding rules: parameter, optimizer, batch and cache spec trees.

Counterpart of ``repro/train/sharding.py``.  Axis convention
(``launch/mesh.py``):

  single-pod mesh (16, 16)        -> ("data", "model")
  multi-pod  mesh (2, 16, 16)     -> ("pod", "data", "model")

Rules:
  * batch dims           -> dp axes ("pod", "data")
  * attention heads, ffn hidden, vocab, MoE experts -> "model"
  * FSDP (cfg.fsdp): the non-"model" weight dim additionally -> "data"
  * KV cache: kv heads on "model" when divisible, else cache seq on "model"
  * optimizer moments shard exactly like their parameters

torch has no PartitionSpec, so the port keeps its own small
:class:`PartitionSpec`: one entry per tensor dim (an axis name, a tuple of
names, or ``None``), normalised as JAX's is (a one-name tuple is the name,
an empty one ``None``), so ``tuple(spec)`` equals the reference's.  It is a
leaf of the port's trees (``train/pytree.py``), not a tuple node.
:func:`placements` turns a spec into DTensor placements on a mesh;
:func:`param_shardings` returns those.

Every function reads the mesh only through its axis names and sizes
(``models.dist.mesh_axes``): a ``DeviceMesh``, or a stand-in with
``axis_names`` and ``shape`` for meshes of more ranks than there are.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.dist import entry_axes, mesh_axes, placements_for
from repro_torch.train.optimizer import OptState
from repro_torch.train.pytree import flatten_with_paths, tree_map, \
    tree_unflatten_like

Pytree = Any


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec:
    """One entry per tensor dim: an axis name, a tuple of names, or
    ``None`` (replicated)."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_canon(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _leaf_pspec(cfg: ModelConfig, path: str, shape: Tuple[int, ...],
                model_size: int, data_size: int) -> P:
    """PartitionSpec for one parameter leaf, identified by its tree path."""
    fsdp = cfg.fsdp
    nd = len(shape)

    def ok(dim: int, axis_size: int) -> bool:
        return 0 <= dim < nd and shape[dim] % axis_size == 0

    def spec(model_dim: Optional[int], data_dim: Optional[int]) -> P:
        entries = [None] * nd
        if model_dim is not None and ok(model_dim, model_size):
            entries[model_dim] = "model"
        if fsdp and data_dim is not None and ok(data_dim, data_size) \
                and entries[data_dim] is None:
            entries[data_dim] = "data"
        return P(*entries)

    # embeddings / heads
    if path.endswith("embed/table"):
        return spec(model_dim=0, data_dim=1)          # (V, D)
    if path.endswith("lm_head"):
        return spec(model_dim=nd - 1, data_dim=nd - 2)  # (D, V)
    if path.endswith("patch_proj") or path.endswith("frame_proj") \
            or path.endswith("fuse"):
        return spec(model_dim=nd - 1, data_dim=nd - 2)

    # attention projections (maybe layer-stacked: leading L dim); archs
    # whose kv heads don't divide the model axis may replicate them over
    # "model" and shard the attention compute by batch instead
    if "/attn/" in path or "/cross/" in path:
        attn_model_ok = cfg.n_kv_heads % model_size == 0 or \
            not cfg.attn_param_replication
        if path.endswith("wo"):
            return spec(model_dim=nd - 2 if attn_model_ok else None,
                        data_dim=nd - 1)
        if path[-2:] in ("wq", "wk", "wv"):
            return spec(model_dim=nd - 1 if attn_model_ok else None,
                        data_dim=nd - 2)
        if path[-2:] in ("bq", "bk", "bv"):
            return spec(model_dim=nd - 1 if attn_model_ok else None,
                        data_dim=None)

    # dense/shared MLP
    if "/mlp/" in path or "shared_w" in path:
        if path.endswith("wd") or path.endswith("w2") \
                or path.endswith("shared_wd"):
            return spec(model_dim=nd - 2, data_dim=nd - 1)
        return spec(model_dim=nd - 1, data_dim=nd - 2)

    # MoE experts: expert dim -> model
    if "/moe/" in path:
        if path.endswith("router"):
            return P(*([None] * nd))     # tiny (D, E): replicated
        if path.endswith("wg") or path.endswith("wu") or path.endswith("wd"):
            # (L, E, D, F) / (L, E, F, D): experts on model, FSDP on dim -2
            return spec(model_dim=nd - 3, data_dim=nd - 2)

    # SSD
    if "/ssd/" in path:
        if path.endswith("in_proj"):
            return spec(model_dim=nd - 1, data_dim=nd - 2)
        if path.endswith("out_proj"):
            return spec(model_dim=nd - 2, data_dim=nd - 1)
        if path.endswith("conv_w") or path.endswith("conv_b"):
            return spec(model_dim=nd - 1, data_dim=None)
        return P(*([None] * nd))  # a_log, dt_bias, d_skip, norm_scale

    # norms / scalars: replicate
    return P(*([None] * nd))


def _path_str(path) -> str:
    """A ``flatten_with_paths`` path as the reference's ``_path_str``
    spells a key path: keys and positions joined by "/"."""
    return "/".join(str(k) for k in path)


def param_pspecs(cfg: ModelConfig, params: Pytree, mesh) -> Pytree:
    axes = mesh_axes(mesh)
    return tree_unflatten_like(params, [
        _leaf_pspec(cfg, _path_str(path), tuple(p.shape), axes["model"],
                    axes["data"])
        for path, p in flatten_with_paths(params)])


def placements(spec: P, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a spec: ``Shard(d)`` on the
    mesh dims that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others.  A tuple entry shards in mesh-dim order (``models/dist.py``)."""
    return tuple(placements_for(list(spec), list(mesh_axes(mesh))))


def param_shardings(cfg: ModelConfig, params: Pytree, mesh) -> Pytree:
    """The placements of :func:`param_pspecs`, leaf for leaf."""
    return tree_map(lambda ps: placements(ps, mesh),
                    param_pspecs(cfg, params, mesh))


def opt_state_pspecs(cfg: ModelConfig, opt_state: OptState,
                     param_specs: Pytree) -> OptState:
    """Moments shard like params; factored moments drop the last or
    second-last entry; the step scalar replicates."""
    def factored(ps: P, drop_last: bool) -> P:
        entries = list(ps)
        if drop_last:
            entries = entries[:-1]
        else:
            entries = entries[:-2] + entries[-1:]
        return P(*entries)

    inner = opt_state.inner
    if isinstance(inner, dict) and set(inner) == {"m", "v"}:
        return OptState(step=P(), inner={"m": param_specs, "v": param_specs})

    # adafactor: a {"vr", "vc"} or {"v"} dict per parameter leaf
    def per_leaf(s, ps):
        if isinstance(s, dict) and "vr" in s:
            return {"vr": factored(ps, drop_last=True),
                    "vc": factored(ps, drop_last=False)}
        return {"v": ps}

    def walk(node, spec):
        if isinstance(node, dict) and ("vr" in node or "v" in node):
            return per_leaf(node, spec)
        return {k: walk(v, spec[k]) for k, v in node.items()}

    return OptState(step=P(), inner=walk(inner, param_specs))


def sanitize_pspecs(specs: Pytree, shapes: Pytree, mesh) -> Pytree:
    """Drop sharding on any dim whose size isn't divisible by its assigned
    mesh axes (e.g. batch=1 decode cells can't shard the batch dim)."""
    axes = mesh_axes(mesh)

    def fix(spec: P, shaped) -> P:
        dims = tuple(shaped.shape)
        entries = list(spec) + [None] * (len(dims) - len(spec))
        out = []
        for dim, entry in zip(dims, entries):
            if entry is None:
                out.append(None)
                continue
            size = 1
            for a in entry_axes(entry):
                size *= axes[a]
            out.append(entry if dim % size == 0 else None)
        return P(*out)

    return tree_map(fix, specs, shapes)


def batch_pspecs(cfg: ModelConfig, mesh) -> Dict[str, P]:
    dp = dp_axes(mesh)
    specs = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.family == "encdec":
        specs["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        specs["patches"] = P(dp, None, None)
    return specs


def decode_state_pspecs(cfg: ModelConfig, mesh) -> Dict[str, P]:
    dp = dp_axes(mesh)
    model_size = mesh_axes(mesh)["model"]
    specs: Dict[str, P] = {"pos": P()}
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        if cfg.n_kv_heads % model_size == 0:
            kv_spec = P(None, dp, None, "model", None)
            sc_spec = P(None, dp, None, "model")
        else:
            kv_spec = P(None, dp, "model", None, None)  # shard cache seq
            sc_spec = P(None, dp, "model", None)
        specs["k"] = kv_spec
        specs["v"] = kv_spec
        specs["k_scale"] = sc_spec
        specs["v_scale"] = sc_spec
    if cfg.family in ("ssm", "hybrid"):
        specs["conv"] = P(None, dp, None, "model")
        if cfg.ssm_heads % model_size == 0:
            specs["ssm"] = P(None, dp, "model", None, None)
        else:
            specs["ssm"] = P(None, dp, None, None, None)
    if cfg.family == "hybrid":
        specs["x0"] = P(dp, None, None)
    if cfg.family == "encdec":
        specs["enc_out"] = P(dp, None, None)
    return specs
