"""Fused Vtotal value and error bound: ``val = sqrt(max(s, 0))`` and
``bound = eps_s / (sqrt(max(s - eps_s, 0)) + val)`` (+inf where that
denominator is 0), with ``s = vx² + vy² + vz²`` and ``eps_s = Σ 2|v|·e + e²``
(paper Thm 1 -> Thm 4 -> Thm 2).

Replaces the Pallas kernel ``repro/kernels/qoi_vtotal.py::_kernel``
(entered through ``qoi_vtotal_fused`` and ``repro/kernels/ops.py::
vtotal_with_bound``).  The CUDA kernel is ``qoi_vtotal`` in
``csrc/level_vtotal.cu``; its note there says what bounds it on an H100
(bytes: five values moved per element) and how its design follows from that.
The reference's lane and row padding of N has no counterpart.

:func:`qoi_vtotal` launches the kernel for CUDA tensors and runs the plain
version :func:`qoi_vtotal_plain` for CPU tensors; for any other device it
raises.  ``eps`` is three host floats, rounded to the inputs' dtype first as
the reference rounds its ``eps`` array.  Every operation of the kernel is
correctly rounded, in the reference's order, so the two are bit-equal.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import qoi_vtotal_ref

DTYPES = {torch.float32: 0, torch.float64: 1}
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def _check(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor,
           eps) -> Tuple[float, float, float]:
    """Validate the inputs; return ``eps`` rounded to their dtype."""
    if isinstance(eps, torch.Tensor):
        raise TypeError("qoi_vtotal: eps must be three host floats, not a "
                        "tensor (reading a device tensor would sync)")
    if not (vx.dtype == vy.dtype == vz.dtype) or vx.dtype not in DTYPES:
        raise TypeError(f"qoi_vtotal: inputs must share float32 or float64, "
                        f"got {vx.dtype}, {vy.dtype}, {vz.dtype}")
    if vx.dim() != 1 or vy.shape != vx.shape or vz.shape != vx.shape:
        raise ValueError(f"qoi_vtotal: inputs must be (N,) of one length, "
                         f"got {tuple(vx.shape)}, {tuple(vy.shape)}, "
                         f"{tuple(vz.shape)}")
    if not all(t.is_contiguous() for t in (vx, vy, vz)):
        raise ValueError("qoi_vtotal: inputs must be contiguous")
    if not vx.device == vy.device == vz.device:
        raise ValueError("qoi_vtotal: inputs must share one device")
    eps = [float(e) for e in eps]
    if len(eps) != 3:
        raise ValueError(f"qoi_vtotal: eps must hold 3 values, got {len(eps)}")
    cast = _NUMPY[vx.dtype]
    return tuple(float(cast(e)) for e in eps)


def qoi_vtotal_plain(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor,
                     eps: Sequence[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same contract)."""
    return qoi_vtotal_ref(vx, vy, vz, _check(vx, vy, vz, eps))


def qoi_vtotal(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor,
               eps: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vx, vy, vz`` (N,) of one dtype (float32 or float64), contiguous,
    and ``eps`` three host floats -> ``(val, bound)``, each (N,)."""
    if vx.device.type == "cpu":
        return qoi_vtotal_plain(vx, vy, vz, eps)
    if vx.device.type != "cuda":
        raise ValueError(f"qoi_vtotal: unsupported device {vx.device}")
    ex, ey, ez = _check(vx, vy, vz, eps)
    n = vx.shape[0]
    val = torch.empty_like(vx)
    bound = torch.empty_like(vx)
    if n == 0:
        return val, bound
    lib = build.load("level_vtotal")
    with torch.cuda.device(vx.device):
        stream = torch.cuda.current_stream(vx.device).cuda_stream
        status = lib.qoi_vtotal(vx.data_ptr(), vy.data_ptr(), vz.data_ptr(),
                                ex, ey, ez, n, DTYPES[vx.dtype],
                                val.data_ptr(), bound.data_ptr(), stream)
    build.check(status, "qoi_vtotal")
    qoi_vtotal.launches += 1
    return val, bound


qoi_vtotal.launches = 0
