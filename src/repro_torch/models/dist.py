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

import torch

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


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the distributed layout the hints
    act on)."""
    if _CTX["mesh"] is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


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
    return _hint_on(mesh, x, entries)


def hint_both(x, *entries):
    """:func:`hint` on ``x``, and on its gradient in the backward: the
    gradient flowing back into ``x`` is redistributed to the placements
    ``entries`` name, where plain ``hint`` leaves it in whatever layout
    the ops after ``x`` give it.  ``x`` itself when :func:`hint` would
    return it."""
    if not is_dtensor(x):
        return x
    return _GradHint.apply(hint(x, *entries), _CTX["mesh"], entries)


class _GradHint(torch.autograd.Function):
    """Identity forward; the gradient redistributed by :func:`_hint_on`."""

    @staticmethod
    def forward(ctx, x, mesh, entries):
        ctx.mesh, ctx.entries = mesh, entries
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        if isinstance(grad, DTensor):
            grad = _hint_on(ctx.mesh, grad, ctx.entries)
        return grad, None, None


def _hint_on(mesh, x, entries):
    """:func:`hint`'s redistribution of the DTensor ``x`` on ``mesh``."""
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


def batch_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors computed
    shard by shard.  For each mesh dim, the first operand dim it shards
    whose letter both operands and the output carry (a batch letter) is
    kept, and the other operand is moved onto the same letter (a local
    slice when it is replicated); a mesh dim that shards no batch letter
    replicates both.  Each device then runs the einsum of its own shards,
    as ``shard_map`` would: DTensor's einsum flattens the batch letters
    into one dim, which has no sharding propagation when two mesh dims
    shard two of them."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    mesh = (a if isinstance(a, DTensor) else b).device_mesh

    def lift(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False)

    a, b = lift(a), lift(b)
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        letter = None
        for x, lx in ((a, la), (b, lb)):
            p = x.placements[i]
            if p.is_shard() and lx[p.dim] in la and lx[p.dim] in lb \
                    and lx[p.dim] in out:
                letter = lx[p.dim]
                break
        if letter is None:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
        else:
            pa.append(Shard(la.index(letter)))
            pb.append(Shard(lb.index(letter)))
            po.append(Shard(out.index(letter)))
    a, b = a.redistribute(mesh, pa), b.redistribute(mesh, pb)
    return DTensor.from_local(torch.einsum(eq, a.to_local(), b.to_local()),
                              mesh, po, run_check=False)


def gather_last(x, idx):
    """``torch.gather(x, -1, idx)``; on a DTensor ``x`` computed shard by
    shard.  ``idx`` takes ``x``'s layout on every other dim, each shard of
    the last dim gathers the indices it holds (zeros for the others), and
    the result is a partial sum over the mesh dims that shard the last
    dim.  DTensor's own gather would do the same forward, but its
    backward scatters into zeros of ``x``'s global shape on every device
    (the logits' at a train step: the whole (B, S, V) float32)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    last = x.dim() - 1
    xp = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(mesh, xp)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ip = [Replicate() if p.is_shard(last) else p for p in xp]
    idx = idx.redistribute(mesh, ip)
    local, at = x.to_local(), idx.to_local()
    n_local = local.shape[-1]
    coord = mesh.get_coordinate()
    first = 0
    for i, p in enumerate(xp):
        if p.is_shard(last):
            first = first * mesh.shape[i] + coord[i]
    at = at - first * n_local
    held = (at >= 0) & (at < n_local)
    got = torch.gather(local, -1, at.clamp(0, n_local - 1))
    got = torch.where(held, got, torch.zeros_like(got))
    out = [Partial() if p.is_shard(last) else q for p, q in zip(xp, ip)]
    return DTensor.from_local(got, mesh, out, run_check=False)


def along(fn, x, dim: int):
    """``fn(x)`` for an op that works along ``dim`` and on each slice along
    it by itself (a cumsum along ``dim``, a pad of ``dim``); a DTensor runs
    it on its local shards, ``dim`` gathered first.  (Some torch releases
    give no sharding strategy to the flip in a cumsum's backward, or fail
    to plan a padded DTensor's redistribution.)"""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    d = dim % x.dim()
    mesh = x.device_mesh
    places = [Replicate() if p.is_shard(d) or p.is_partial() else p
              for p in x.placements]
    x = x.redistribute(mesh, places)
    return DTensor.from_local(fn(x.to_local()), mesh, places,
                              run_check=False)


def take_rows(table, idx):
    """``table[idx]``; on a DTensor ``table`` computed shard by shard: the
    table keeps only its sharding of dim 0, the indices only their
    sharding of their dim 0 on the other mesh dims, and each shard looks
    up the indices it holds (zeros for the others), a partial sum over the
    mesh dims that shard the table's rows.  DTensor's own lookup does the
    same, but some torch releases refuse indices sharded over two mesh
    dims (a batch over ("pod", "data"))."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    tp = [p if p.is_shard(0) else Replicate() for p in table.placements]
    kp = [Replicate() if t.is_shard(0) or not p.is_shard(0) else p
          for t, p in zip(tp, idx.placements)]
    table = table.redistribute(mesh, tp)
    idx = idx.redistribute(mesh, kp)
    local, at = table.to_local(), idx.to_local()
    n_local = local.shape[0]
    coord = mesh.get_coordinate()
    first = 0
    for i, p in enumerate(tp):
        if p.is_shard(0):
            first = first * mesh.shape[i] + coord[i]
    at = at - first * n_local
    held = (at >= 0) & (at < n_local)
    rows = local[at.clamp(0, n_local - 1)]
    held = held.reshape(held.shape + (1,) * (rows.dim() - held.dim()))
    rows = torch.where(held, rows, torch.zeros_like(rows))
    out = [Partial() if t.is_shard(0) else k for t, k in zip(tp, kp)]
    return DTensor.from_local(rows, mesh, out, run_check=False)


def put_rows(n_rows: int, idx, values):
    """``torch.zeros((n_rows,) + values.shape[1:]).index_put((idx,),
    values)``: ``values``' rows written at rows ``idx`` of zeros.  On
    DTensors computed shard by shard: each shard writes the rows its
    indices hold into zeros of its own, a partial sum over the mesh dims
    that shard the indices, equal to the write where no row is written
    twice (the caller's pad row, written by every dropped row, is
    discarded).  The backward of DTensor's own write indexes the gradient
    by the indices, which some torch releases refuse for indices sharded
    over two mesh dims."""
    if not (is_dtensor(idx) or is_dtensor(values)):
        return torch.zeros((n_rows,) + tuple(values.shape[1:]),
                           dtype=values.dtype,
                           device=values.device).index_put((idx,), values)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ref = idx if isinstance(idx, DTensor) else values
    mesh = ref.device_mesh
    places = [p if p.is_shard(0) else Replicate() for p in ref.placements]

    def local(x):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, places).to_local()

    at, rows = local(idx), local(values)
    out = torch.zeros((n_rows,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device).index_put((at,), rows)
    return DTensor.from_local(
        out, mesh, [Partial() if p == Shard(0) else Replicate()
                    for p in places], run_check=False)
