"""One hierarchical-surplus lifting level over a batch of 1-D lines:
``d = x_odd - 0.5 * (x_even[:, :-1] + x_even[:, 1:])``.

Replaces the Pallas kernel ``repro/kernels/hier_level.py::_kernel``
(entered through ``hier_level_surplus`` and ``repro/kernels/ops.py::
level_surplus``).  The CUDA kernel is ``hier_level_surplus`` in
``csrc/level_vtotal.cu``; its note there says what bounds it on an H100
(bytes: three values moved per output) and how its design follows from that.
The reference's ``rows`` multiple and its row and lane padding have no
counterpart: the kernel takes any B >= 1 and M >= 1 and masks the ragged
edge itself.

:func:`hier_level_surplus` launches the kernel for CUDA tensors and runs the
plain version :func:`hier_level_surplus_plain` for CPU tensors; for any
other device it raises.  The two are bit-equal (``0.5 * s`` is exact).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hier_level_surplus_ref

DTYPES = {torch.float32: 0, torch.float64: 1}


def _check(x_even: torch.Tensor, x_odd: torch.Tensor) -> None:
    if x_even.dtype != x_odd.dtype or x_odd.dtype not in DTYPES:
        raise TypeError(f"hier_level_surplus: inputs must share float32 or "
                        f"float64, got {x_even.dtype} and {x_odd.dtype}")
    if x_odd.dim() != 2 or x_odd.shape[0] < 1 or x_odd.shape[1] < 1:
        raise ValueError(f"hier_level_surplus: x_odd must be (B, M) with "
                         f"B, M >= 1, got {tuple(x_odd.shape)}")
    b, m = x_odd.shape
    if tuple(x_even.shape) != (b, m + 1):
        raise ValueError(f"hier_level_surplus: x_even {tuple(x_even.shape)} "
                         f"vs x_odd {tuple(x_odd.shape)}")
    if not (x_even.is_contiguous() and x_odd.is_contiguous()):
        raise ValueError("hier_level_surplus: inputs must be contiguous")
    if x_even.device != x_odd.device:
        raise ValueError("hier_level_surplus: inputs must share one device")


def hier_level_surplus_plain(x_even: torch.Tensor,
                             x_odd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    _check(x_even, x_odd)
    return hier_level_surplus_ref(x_even, x_odd)


def hier_level_surplus(x_even: torch.Tensor,
                       x_odd: torch.Tensor) -> torch.Tensor:
    """``x_even`` (B, M+1) coarse nodes and ``x_odd`` (B, M) new nodes, one
    dtype (float32 or float64), contiguous -> (B, M) surpluses."""
    if x_odd.device.type == "cpu":
        return hier_level_surplus_plain(x_even, x_odd)
    if x_odd.device.type != "cuda":
        raise ValueError(f"hier_level_surplus: unsupported device "
                         f"{x_odd.device}")
    _check(x_even, x_odd)
    b, m = x_odd.shape
    out = torch.empty_like(x_odd)
    lib = build.load("level_vtotal")
    with torch.cuda.device(x_odd.device):
        stream = torch.cuda.current_stream(x_odd.device).cuda_stream
        status = lib.hier_level_surplus(x_even.data_ptr(), x_odd.data_ptr(),
                                        b, m, DTYPES[x_odd.dtype],
                                        out.data_ptr(), stream)
    build.check(status, "hier_level_surplus")
    hier_level_surplus.launches += 1
    return out


hier_level_surplus.launches = 0
