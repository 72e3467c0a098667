"""Device meshes over a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``: :func:`make_mesh` and
:func:`make_mesh_for` build a ``DeviceMesh`` with named dims ("data",
"model", and "pod" for two pods) over the default process group, one rank
per device.

A function, not a module-level constant: importing this module touches no
device and no process group.  The caller makes the default group first,
one process per rank, for example::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://localhost:29500", rank=r, world_size=n)

(``"gloo"`` and a ``FileStore`` for CPU ranks).  A CUDA mesh needs the NCCL
backend and a CPU mesh the gloo backend: the port never falls back from one
to the other, and never makes a default group behind the caller's back.

The reference's ``make_production_mesh`` (a (16, 16) or (2, 16, 16) mesh of
256 or 512 fake devices, for its dry runs) is not here: it needs a fake
process group of 256 ranks, which comes with the port's launch tools
(``ROADMAP.md`` A13).  The sharding rules (``train/sharding.py``) take any
object with ``axis_names`` and ``shape`` for such shapes meanwhile.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

_HOW = ("call torch.distributed.init_process_group(backend, "
        "init_method='tcp://localhost:<port>' (or store=FileStore(path, n)), "
        "rank=r, world_size=n) in each of the n processes first")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group.  ``device_type=None`` means CUDA with the NCCL
    backend and raises without CUDA; ``"cpu"`` means gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if device_type is None else str(device_type)
    if kind not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {kind!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "for a mesh of CPU ranks")
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"no default process group: {_HOW}")
    backend = str(dist.get_backend())
    if _BACKEND[kind] not in backend:
        raise RuntimeError(f"a {kind} mesh needs the {_BACKEND[kind]} "
                           f"backend; the default group uses {backend!r}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the default group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(kind, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_mesh_for(n_devices: int, model_parallel: int = 1, *,
                  device_type: Optional[str] = None):
    """A ("data", "model") mesh of ``n_devices`` ranks with
    ``model_parallel`` of them on "model"."""
    data = n_devices // model_parallel
    return make_mesh((data, model_parallel), ("data", "model"),
                     device_type=device_type)
