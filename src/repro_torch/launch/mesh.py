"""Device meshes over a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``: :func:`make_mesh` and
:func:`make_mesh_for` build a ``DeviceMesh`` with named dims ("data",
"model", and "pod" for two pods) over the default process group, one rank
per device, and :func:`make_production_mesh` the reference's (16, 16) and
(2, 16, 16) meshes.

A function, not a module-level constant: importing this module touches no
device and no process group.  The caller makes the default group first,
one process per rank, for example::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://localhost:29500", rank=r, world_size=n)

(``"gloo"`` and a ``FileStore`` for CPU ranks).  A CUDA mesh needs the NCCL
backend and a CPU mesh the gloo backend: the port never falls back from one
to the other, and never makes a default group behind the caller's back.

The production meshes are for dry runs (``launch/dryrun.py``): 256 or 512
devices that one process stands in for.  :func:`init_fake_process_group`
makes that process's default group with torch's ``fake`` backend, whose
collectives move nothing, as the reference's
``--xla_force_host_platform_device_count=512`` gives one process 512 host
devices.  Either device type takes a fake group.  The sharding rules
(``train/sharding.py``) also take any object with ``axis_names`` and
``shape``, so they need no group at all.

Roofline constants of the card (per device): NVIDIA H100 SXM5 80GB (700 W
power limit) from NVIDIA's H100 Tensor Core GPU data sheet -- 989.4
TFLOP/s dense bf16, 3.35 TB/s HBM3, and 900 GB/s NVLink (4th generation,
18 links, bidirectional).  The reference's are TPU v5e's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# H100 SXM5 80GB (700 W) roofline constants, per device
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, dense
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 900e9               # B/s per device, all links, both ways

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_FAKE = "fake"

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

_HOW = ("call torch.distributed.init_process_group(backend, "
        "init_method='tcp://localhost:<port>' (or store=FileStore(path, n)), "
        "rank=r, world_size=n) in each of the n processes first")


def _check_backend(kind: str) -> None:
    """Raise unless a ``kind`` mesh can sit on the default group: CUDA
    present for a CUDA mesh, and the group's backend NCCL (CUDA), gloo
    (CPU) or fake (either)."""
    import torch.distributed as dist

    if kind not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {kind!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "for a mesh of CPU ranks")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"no default process group: {_HOW}")
    backend = str(dist.get_backend())
    if _BACKEND[kind] not in backend and backend != _FAKE:
        raise RuntimeError(f"a {kind} mesh needs the {_BACKEND[kind]} "
                           f"(or the {_FAKE}) backend; the default group "
                           f"uses {backend!r}")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group.  ``device_type=None`` means CUDA with the NCCL
    backend and raises without CUDA; ``"cpu"`` means gloo.  A fake group
    (:func:`init_fake_process_group`) serves either."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if device_type is None else str(device_type)
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)}")
    _check_backend(kind)
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


def init_fake_process_group(world_size: int) -> None:
    """Make this process rank 0 of a default group of ``world_size`` ranks
    with torch's ``fake`` backend: collectives are recorded by the
    dispatcher and move nothing.  Raises ``RuntimeError`` if a default
    group exists or this torch lacks the fake backend (there is no other
    group to fall back to)."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already "
                           f"({dist.get_backend()!r}, "
                           f"{dist.get_world_size()} ranks): the fake group "
                           "needs a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group backend "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    dist.init_process_group(_FAKE, store=FakeStore(), rank=0,
                             world_size=int(world_size))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's production mesh: ("data", "model") of (16, 16), or
    ("pod", "data", "model") of (2, 16, 16) with ``multi_pod``, on the
    first 256 or 512 ranks of the default group (a fake group of 512
    ranks holds both, as the reference's 512 host devices do).
    ``device_type`` is as :func:`make_mesh`'s."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           f"init_fake_process_group({n}) first")
    if dist.get_world_size() == n:
        return make_mesh(shape, axes, device_type=device_type)
    if dist.get_world_size() < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the default "
                         f"group has {dist.get_world_size()}")
    kind = "cuda" if device_type is None else str(device_type)
    _check_backend(kind)
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
