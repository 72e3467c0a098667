"""Fused multiply-add with one rounding: ``fma(a, b, c) = RN(a*b + c)``.

No Pallas kernel of the reference computes this.  The reference evaluates
its QoI bounds (``repro/core/retrieval.py::_estimate``) and its ob
transform (``repro/transform/orthogonal.py``) under ``jax.jit``, and XLA's
CPU backend contracts a multiply whose only use is an add or subtract into
one fused multiply-add (ROADMAP C3).  The port rounds exactly as the
reference does by calling :func:`fma` at those places.

:func:`fma` launches the CUDA kernel ``fma_rn`` (``csrc/fma.cu``) for CUDA
tensors and runs the plain version :func:`repro_torch.kernels.ref.fma_ref`
(an exact emulation by error-free transformations) for CPU tensors; for any
other device it raises.  The two are bit-equal on every float64 input,
inf, NaN and signed zeros included.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.device import F64
from repro_torch.kernels import build, ref

Operand = Union[torch.Tensor, float]


def _device(a: Operand, b: Operand, c: Operand) -> torch.device:
    """The one device of the tensor operands; each must be float64."""
    ts = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    if not ts:
        raise TypeError("fma: at least one operand must be a tensor")
    for t in ts:
        if t.dtype != F64:
            raise TypeError(f"fma: operands must be float64, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError("fma: operands must share one device")
    return ts[0].device


def _launch_operand(x: Operand, shape: torch.Size):
    """(pointer or None, value, stride) of one operand for the kernel, and
    the tensor to keep alive until the launch: a Python float goes by
    value, a tensor holding one value (0-d, or an expanded view) by pointer
    with stride 0, a contiguous full-shape tensor with stride 1, and a 1-D
    full-shape view of any element stride (``even[1:]`` of a 1-D field,
    stride 2) by pointer and that stride.  Only a multi-dimensional
    non-contiguous operand, or one broadcast along some of its dimensions,
    is copied out to full shape."""
    if not isinstance(x, torch.Tensor):
        return (None, float(x), 0), None
    if x.shape == shape and x.is_contiguous():
        return (x.data_ptr(), 0.0, 1), x
    if all(st == 0 or sz == 1 for st, sz in zip(x.stride(), x.shape)):
        return (x.data_ptr(), 0.0, 0), x
    if x.dim() == 1 and x.shape == shape:
        return (x.data_ptr(), 0.0, x.stride(0)), x
    x = x.expand(shape).contiguous()
    return (x.data_ptr(), 0.0, 1), x


def _kernel():
    """The C entry point ``fma_rn``, built and loaded at the first launch
    and then kept, so a launch costs no lookup."""
    global _fma_rn
    if _fma_rn is None:
        _fma_rn = build.load("fma").fma_rn
    return _fma_rn


_fma_rn = None


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """``a*b + c`` rounded once, elementwise over the broadcast of float64
    tensors (a Python float is a scalar on the tensors' device)."""
    dev = _device(a, b, c)
    if dev.type == "cpu":
        return ref.fma_ref(*(x if isinstance(x, torch.Tensor)
                             else torch.tensor(x, dtype=F64)
                             for x in (a, b, c)))
    if dev.type != "cuda":
        raise ValueError(f"fma: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fma(a, b, c)
    # torch.broadcast_shapes takes tens of µs, more than the kernel at the
    # path's short lengths; the operands' shapes are most often equal
    shapes = [x.shape for x in (a, b, c) if isinstance(x, torch.Tensor)]
    shape = shapes[0] if all(sh == shapes[0] for sh in shapes) \
        else torch.broadcast_shapes(*shapes)
    out = torch.empty(shape, dtype=F64, device=dev)
    if out.numel() == 0:
        return out
    args, keep = zip(*(_launch_operand(x, shape) for x in (a, b, c)))
    status = _kernel()(*args[0], *args[1], *args[2], out.numel(),
                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    del keep
    build.check(status, "fma_rn")
    fma.launches += 1
    return out


fma.launches = 0
