"""Carry an archive, or a model's parameters, across as plain Python and
numpy data.

:func:`archive_to_arrays` flattens a port :class:`Archive` into a dict of
ints, floats, tuples, bytes and numpy arrays; :func:`archive_from_arrays`
builds an Archive back from such a dict, on a device.  Any producer of the
same layout — the JAX package's archive included — can hand its archive to
the port this way, so both packages retrieve from the very same bytes.

Layout::

    {"method": "hb" | "ob" | "ip" | "psz3" | "psz3_delta",
     "shapes": {name: tuple}, "ranges": {name: float},
     "masks": {name: {"mask": bool array, "values": float64 array}},
     "variables": {name: <bitplane variable> | <snapshot variable>}}

    bitplane variable (hb, ob, ip):
        {"orig_shape": tuple, "padded_shape": tuple, "levels": int,
         "group_indices": [int64 array],
         "groups": [{"count": int, "exponent": int | None, "nbits": int,
                     "planes": [bytes], "signs": bytes,
                     "pred_planes": int | None}]}

    snapshot variable (psz3, psz3_delta; ``eps_ladder`` only with delta):
        {"delta": bool, "eps_ladder": [float],
         "snapshots": [{"eps": float, "orig_shape": tuple,
                        "padded_shape": tuple, "levels": int,
                        "dtypes": [str], "amax": float, "blobs": [bytes]}]}

``pred_planes`` (the ip method's prediction depth) may be left out.

:func:`params_from_arrays` and :func:`params_to_arrays` do the same for a
model's parameter tree, of any family (nested dicts of numpy arrays, the
JAX package's ``jax.tree.map(np.asarray, params)``), so both packages
compute from the same weights; :func:`decode_state_from_arrays` and
:func:`decode_state_to_arrays` carry a decode state across (a dict of numpy
arrays with ``init_decode_state``'s keys), for example encdec's ``enc_out``
or a state part-way through a sequence.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.bitplane.encoder import LevelBitplanes
from repro_torch.compressors.snapshots import DeltaSnapshotArchive, \
    SnapshotArchive
from repro_torch.compressors.szlike import SZCompressed
from repro_torch.core.masks import OutlierMask
from repro_torch.core.refactor import (
    BITPLANE_METHODS,
    METHODS,
    Archive,
    BitplaneVarArchive,
    SnapshotVarArchive,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, \
    init_decode_state, leaf_dtype


def _snapshot_var(v: Dict[str, Any]) -> SnapshotVarArchive:
    snaps = [SZCompressed(eps=float(s["eps"]),
                          orig_shape=tuple(s["orig_shape"]),
                          padded_shape=tuple(s["padded_shape"]),
                          levels=int(s["levels"]),
                          blobs=[bytes(b) for b in s["blobs"]],
                          dtypes=[str(d) for d in s["dtypes"]],
                          amax=float(s["amax"]))
             for s in v["snapshots"]]
    if not v["delta"]:
        return SnapshotVarArchive(SnapshotArchive(snapshots=snaps))
    return SnapshotVarArchive(DeltaSnapshotArchive(
        snapshots=snaps, eps_ladder=[float(e) for e in v["eps_ladder"]]))


def _snapshot_arrays(var: SnapshotVarArchive) -> Dict[str, Any]:
    arch = var.archive
    delta = isinstance(arch, DeltaSnapshotArchive)
    out = {"delta": delta,
           "snapshots": [{"eps": s.eps, "orig_shape": tuple(s.orig_shape),
                          "padded_shape": tuple(s.padded_shape),
                          "levels": int(s.levels), "dtypes": list(s.dtypes),
                          "amax": s.amax, "blobs": list(s.blobs)}
                         for s in arch.snapshots]}
    if delta:
        out["eps_ladder"] = list(arch.eps_ladder)
    return out


def archive_from_arrays(d: Dict[str, Any], device: DeviceLike = None
                        ) -> Archive:
    """Build a port Archive from the plain layout; sessions on it decode on
    ``device`` (default CUDA; raises without it unless ``device="cpu"``)."""
    if d["method"] not in METHODS:
        raise ValueError(f"archive method {d['method']!r} is not ported; "
                         f"expected one of {METHODS}")
    dev = resolve_device(device)
    variables = {}
    for name, v in d["variables"].items():
        if d["method"] not in BITPLANE_METHODS:
            variables[name] = _snapshot_var(v)
            continue
        groups = [LevelBitplanes(count=int(g["count"]),
                                 exponent=None if g["exponent"] is None
                                 else int(g["exponent"]),
                                 nbits=int(g["nbits"]),
                                 planes=[bytes(p) for p in g["planes"]],
                                 plane_raw_bits=int(g["count"]),
                                 signs=bytes(g["signs"]),
                                 pred_planes=g.get("pred_planes"))
                  for g in v["groups"]]
        variables[name] = BitplaneVarArchive(
            method=d["method"], orig_shape=tuple(v["orig_shape"]),
            padded_shape=tuple(v["padded_shape"]), levels=int(v["levels"]),
            groups=groups,
            group_indices=[np.asarray(i, dtype=np.int64)
                           for i in v["group_indices"]])
    masks = {name: OutlierMask(mask=np.asarray(m["mask"], dtype=bool),
                               values=np.asarray(m["values"],
                                                 dtype=np.float64))
             for name, m in d["masks"].items()}
    return Archive(method=d["method"], variables=variables, masks=masks,
                   ranges={k: float(r) for k, r in d["ranges"].items()},
                   shapes={k: tuple(s) for k, s in d["shapes"].items()},
                   device=dev)


def archive_to_arrays(archive) -> Dict[str, Any]:
    """Inverse of :func:`archive_from_arrays` (the device is not part of
    the layout)."""
    if archive.method not in BITPLANE_METHODS:
        variables = {name: _snapshot_arrays(v)
                     for name, v in archive.variables.items()}
    else:
        variables = {
            name: {"orig_shape": tuple(v.orig_shape),
                   "padded_shape": tuple(v.padded_shape),
                   "levels": int(v.levels),
                   "group_indices": [np.asarray(i)
                                     for i in v.group_indices],
                   "groups": [{"count": g.count, "exponent": g.exponent,
                               "nbits": g.nbits, "planes": list(g.planes),
                               "signs": g.signs,
                               "pred_planes": g.pred_planes}
                              for g in v.groups]}
            for name, v in archive.variables.items()}
    return {
        "method": archive.method,
        "shapes": {k: tuple(s) for k, s in archive.shapes.items()},
        "ranges": {k: float(r) for k, r in archive.ranges.items()},
        "masks": {k: {"mask": np.asarray(m.mask),
                      "values": np.asarray(m.values)}
                  for k, m in archive.masks.items()},
        "variables": variables,
    }


def _tensor(a, dtype, device):
    """A numpy array (bfloat16 ones included, read by their bits, so no
    bfloat16 numpy type is needed) -> a tensor of ``dtype`` on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_arrays(tree: Dict[str, Any], cfg: ModelConfig,
                       device: DeviceLike = None) -> Transformer:
    """A model whose parameters are ``tree``'s values, each leaf cast to
    its dtype in ``cfg``'s tree (``transformer.leaf_dtype``: float32 for
    the router and the SSD's ``a_log``, ``dt_bias`` and ``d_skip``,
    ``cfg.param_dtype`` otherwise; exact for the reference's own
    parameters) on ``device`` (default CUDA)."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        return _tensor(node, leaf_dtype(cfg, path), dev)
    return Transformer(cfg, params=conv(tree, ()))


def params_to_arrays(model: Transformer) -> Dict[str, Any]:
    """Inverse of :func:`params_from_arrays`: the parameter tree as numpy
    arrays on the host; bfloat16 leaves come out as float32 (exact), and
    :func:`params_from_arrays` casts them back by path."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()
    return conv(model.tree())


def decode_state_from_arrays(tree: Dict[str, Any], cfg: ModelConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """A decode state of ``cfg``'s family from numpy arrays (the JAX
    package's ``jax.tree.map(np.asarray, state)``, or
    :func:`decode_state_to_arrays`), each leaf cast to its dtype in
    ``init_decode_state(cfg, ...)`` (exact for such a state), on ``device``
    (default CUDA).  Raises if the keys are not that layout's."""
    dev = resolve_device(device)
    layout = init_decode_state(cfg, 0, 0, device="cpu")
    if set(tree) != set(layout):
        raise ValueError(f"decode state keys {sorted(tree)}, expected "
                         f"{sorted(layout)} for family {cfg.family!r}")
    return {k: _tensor(tree[k], t.dtype, dev) for k, t in layout.items()}


def decode_state_to_arrays(state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`decode_state_from_arrays`: numpy arrays on the
    host; bfloat16 leaves come out as float32 (exact), which
    :func:`decode_state_from_arrays` casts back."""
    out = {}
    for k, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[k] = t.numpy().copy()
    return out
