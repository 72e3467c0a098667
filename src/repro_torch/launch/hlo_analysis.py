"""Per-device op analysis of one eager step: dot FLOPs, bytes, collectives.

Counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses the
partitioned (per-device) HLO module of a compiled step.  torch has no HLO:
the port's step is eager, so its counterpart of the partitioned module is
the stream of aten ops that one device runs, which :class:`OpCounter` (a
``TorchDispatchMode``) records as the step runs:

  * FLOPs: every matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``dot``: what ``matmul`` and ``einsum`` lower to) contributes
    2·prod(output)·(contracted size), as the reference's ``dot`` does;
  * collective bytes: output bytes of every collective, by the reference's
    five kinds -- the functional collectives (``_c10d_functional``) that
    DTensor's redistributions run and the process-group ops (``c10d``)
    that ``compressed_psum`` runs;
  * memory traffic estimate: Σ output bytes over compute ops, bookkeeping
    excluded -- views, reshapes, clones, copies, allocations and fills
    (the reference's parameter, constant, tuple, bitcast, copy, iota,
    broadcast, reshape); a dtype cast counts, as XLA's ``convert`` does;
  * ``peak_bytes``: the most bytes that storages allocated inside the
    step held at once (saved activations included), which the dry run's
    ``temp_bytes`` reads.

Everything is per device.  On DTensors the mode sees the local ops: it
declines an op whose arguments are DTensors, DTensor runs it as local ops
on its shards (and collectives for its redistributions), and those come
back through the mode.  (A mode that counted the DTensor op itself would
count the global shape, 16× or 256× a device's work.)  DTensor's sharding
propagation runs ops on global-shape tensors to learn output shapes; ops
called from it (``torch/distributed/tensor/_sharding_prop.py``), on the
``meta`` device, or in the ``prim`` namespace are no device's work and
are skipped.

Trip counts are moot: the eager step runs every layer, so each op is
recorded each time it runs.  ``n_dots`` and ``n_collectives`` therefore
count executions, where the reference counts HLO instructions (a layer
loop's body once).

Usage::

    with OpCounter() as c:
        step(...)
    stats = c.stats()
"""
from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op names (namespace stripped) -> the reference's collective kinds
_COLLECTIVE_KIND = {
    # _c10d_functional
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # c10d process-group ops
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# ops that move or alias data but compute nothing, or only allocate
_BOOKKEEPING = {
    "clone", "copy", "copy_", "_copy_from", "_copy_from_and_resize",
    "contiguous", "detach", "detach_", "lift_fresh", "lift_fresh_copy",
    "alias", "_unsafe_view", "view", "reshape", "_reshape_alias",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill",
    "fill_", "zero_", "scalar_tensor", "arange", "_local_scalar_dense",
    "wait_tensor", "resize_", "set_", "record_stream",
}

# matrix products: op name -> index of the operand whose last dim (first
# for ``dot``) is contracted
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "mv": 0, "addmv": 1,
         "dot": 0, "vdot": 0}

_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs ops on fake tensors of the global shape to learn an output's
    shape: no device runs them."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


def shape_str(t: torch.Tensor) -> str:
    """``bf16[16,4096,2048]``, as HLO prints a shape."""
    return (f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(int(d)) for d in t.shape)}]")


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


@dataclass
class OpRecord:
    """One op a device ran: its name, its outputs' shapes and bytes, its
    dot FLOPs and its collective kind ('' if none)."""
    op: str
    shape: str
    out_bytes: int
    flops: float = 0.0
    collective: str = ""


@dataclass
class HloStats:
    flops: float
    dot_flops: float
    memory_bytes: float
    collectives: Dict[str, Dict[str, float]]
    collective_bytes: float
    n_dots: int
    n_collectives: int
    peak_bytes: float = 0.0
    n_ops: int = 0
    records: List[OpRecord] = field(default_factory=list, repr=False)


class OpCounter(TorchDispatchMode):
    """Records every op one device runs while it is active (see the
    module's note).  ``keep_records`` keeps the per-op records that
    ``launch/diag.py`` groups; the totals are kept either way."""

    def __init__(self, keep_records: bool = True, watch=()):
        super().__init__()
        self.keep_records = keep_records
        # storages of the step's inputs, and those of them a compute op
        # read (not a view: an unbound leaf nothing reads stays unread)
        self.watch = {t.untyped_storage()._cdata for t in watch}
        self.read = set()
        self.records: List[OpRecord] = []
        self.dot_flops = 0.0
        self.memory_bytes = 0.0
        self.n_dots = 0
        self.n_ops = 0
        self.colls = {k: {"count": 0.0, "bytes": 0.0}
                      for k in COLLECTIVE_OPS}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- storage accounting -------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = int(st.nbytes())
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim" or _in_sharding_propagation():
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" for t in outs):
            return out
        name = func._opname
        self.n_ops += 1
        for t in outs:
            self._track(t)
        out_bytes = sum(_nbytes(t) for t in outs)
        rec = OpRecord(op=f"{ns}.{name}",
                       shape=", ".join(shape_str(t) for t in outs[:4]),
                       out_bytes=out_bytes)
        kind = _COLLECTIVE_KIND.get(name) \
            if ns in ("_c10d_functional", "c10d") else None
        if kind is not None:
            rec.collective = kind
            self.colls[kind]["count"] += 1
            self.colls[kind]["bytes"] += out_bytes
        elif ns == "aten" and name in _DOTS:
            a = args[_DOTS[name]]
            contract = int(a.shape[0] if name in ("dot", "vdot")
                           else a.shape[-1])
            rec.flops = 2.0 * float(outs[0].numel()) * contract
            self.dot_flops += rec.flops
            self.n_dots += 1
        if name not in _BOOKKEEPING and not func.is_view:
            self.memory_bytes += out_bytes
        if self.watch and not func.is_view:
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    key = t.untyped_storage()._cdata
                    if key in self.watch:
                        self.read.add(key)
        if self.keep_records:
            self.records.append(rec)
        return out

    def stats(self) -> HloStats:
        colls = {k: dict(v) for k, v in self.colls.items()}
        total = sum(v["bytes"] for v in colls.values())
        n_coll = int(sum(v["count"] for v in colls.values()))
        return HloStats(flops=self.dot_flops, dot_flops=self.dot_flops,
                        memory_bytes=self.memory_bytes, collectives=colls,
                        collective_bytes=total, n_dots=self.n_dots,
                        n_collectives=n_coll,
                        peak_bytes=float(self.peak_bytes),
                        n_ops=self.n_ops,
                        records=list(self.records))


def analyze(fn, *args, keep_records: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`;
    returns (its result, the :class:`HloStats`)."""
    with OpCounter(keep_records=keep_records) as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats()


def stats_dict(h: HloStats) -> Dict[str, object]:
    """The dry run's ``hlo`` entry: the reference's keys."""
    return {"dot_flops": h.flops, "memory_bytes_proxy": h.memory_bytes,
            "collective_bytes": h.collective_bytes,
            "collectives": {k: v for k, v in h.collectives.items()
                            if v["count"]},
            "n_dots": h.n_dots, "n_collectives": h.n_collectives}


def collectives_by_kind(h: HloStats) -> Dict[str, object]:
    """The dry run's ``collectives`` entry: count and bytes by kind, and
    their total (the reference's ``parse_collective_bytes`` layout)."""
    out: Dict[str, object] = {k: {"count": int(v["count"]),
                                  "bytes": int(v["bytes"])}
                              for k, v in h.collectives.items()}
    out["total_bytes"] = int(h.collective_bytes)
    return out

