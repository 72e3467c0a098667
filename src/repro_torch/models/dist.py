"""Distribution context for model-internal sharding hints.

Counterpart of ``repro/models/dist.py``.  Model code is mesh-agnostic by
default; a launcher registers the active ``DeviceMesh`` here
(:func:`set_mesh`, :func:`use_mesh`), and layers consult it to place
sharding hints whose need depends on the mesh's geometry (batch-parallel
attention only when kv heads don't divide the "model" axis).

The reference's :func:`hint` is ``with_sharding_constraint``: it fixes the
layout of a traced array and never its values.  Eager torch has no layout
to constrain on a plain tensor, so ``hint`` returns ``x`` unchanged when no
mesh is registered or ``x`` is a plain tensor.  A ``DTensor`` is
redistributed to the placements its entries name:

* an axis name, or a tuple of names -> ``Shard(dim)`` on those mesh dims;
* :data:`REP` -> that tensor dim replicated: a mesh dim sharding it goes to
  ``Replicate()``;
* ``None`` -> unconstrained (the reference's ``UNCONSTRAINED``): a mesh dim
  that shards this tensor dim keeps its placement.

A mesh dim that no entry names keeps its placement if it shards an
unconstrained dim, and is otherwise replicated.  An entry naming an axis
the mesh lacks leaves ``x`` unchanged; an entry whose axes' size does not
divide its dim is left unconstrained (DTensor would pad the shards; JAX's
specs never shard a dim they don't divide).

Shard order: JAX shards a dim over a tuple of axes major to minor in the
tuple's order; DTensor shards it in mesh-dim order.  The two agree when the
tuple is in mesh order, as every spec of ``train/sharding.py`` is.
``layers._full_batch_axes`` returns ("data", "model", "pod") on a ("pod",
"data", "model") mesh: there the port's devices hold the batch's blocks in
another order than the reference's.  That is layout only; values are
unchanged.

Both this module and ``train/sharding.py`` read a mesh only through its
axis names and sizes (:func:`mesh_axes`): a ``DeviceMesh`` with
``mesh_dim_names``, or any object with ``axis_names`` and a ``shape``
mapping, as a JAX mesh has.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

_CTX: Dict[str, Any] = {"mesh": None}

# hint() entry sentinel: force this dim replicated (vs None = unconstrained)
REP = "__replicated__"


def set_mesh(mesh) -> None:
    _CTX["mesh"] = mesh


@contextmanager
def use_mesh(mesh):
    prev = _CTX["mesh"]
    _CTX["mesh"] = mesh
    try:
        yield
    finally:
        _CTX["mesh"] = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's dim order."""
    if hasattr(mesh, "mesh_dim_names"):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_size(name: str) -> int:
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    return mesh_axes(mesh).get(name, 1)


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry: () for ``None``."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements_for(entries: Sequence, names: Sequence[str],
                   current: Optional[Sequence] = None) -> List:
    """DTensor placements, one per mesh dim of ``names``, for the tensor
    dims' ``entries`` (axis names, tuples of them, :data:`REP` or ``None``).
    A mesh dim that no entry names keeps its ``current`` placement when
    that shards a dim whose entry is ``None``, and is otherwise
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    named: Dict[int, int] = {}
    constrained = set()
    for dim, e in enumerate(entries):
        if e is None:
            continue
        constrained.add(dim)
        if e == REP:
            continue
        for a in entry_axes(e):
            named[names.index(a)] = dim
    out = []
    for i in range(len(names)):
        if i in named:
            out.append(Shard(named[i]))
            continue
        cur = current[i] if current is not None else None
        keep = cur is not None and (
            cur.is_replicate()
            or (cur.is_shard() and cur.dim not in constrained))
        out.append(cur if keep else Replicate())
    return out


def hint(x, *entries):
    """The reference's sharding constraint: a ``DTensor`` redistributed to
    the placements ``entries`` name; ``x`` itself when no mesh is
    registered, ``x`` is a plain tensor, or an entry names an axis the
    mesh lacks.  Values never change."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, e in zip(x.shape, entries):
        if e is None or e == REP:
            fixed.append(e)
            continue
        size = 1
        for a in entry_axes(e):
            if a not in sizes:
                return x
            size *= sizes[a]
        fixed.append(e if dim % size == 0 else None)
    dm = x.device_mesh
    if list(mesh_axes(dm)) != list(sizes):
        raise ValueError(f"hint: the tensor's mesh {mesh_axes(dm)} is not "
                         f"the registered mesh {sizes}")
    want = placements_for(fixed, list(sizes), x.placements)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(dm, want)
