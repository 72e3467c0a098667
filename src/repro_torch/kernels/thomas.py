"""Batched Thomas solve of the ob transform's L² projection.

No Pallas kernel of the reference computes this: it is the jnp graph
``repro/transform/orthogonal.py::_thomas_axis``, two ``lax.scan`` over the
nodes of every line along one axis.  A torch op per node is not viable on
the card (a 1-D field of 2^24 points has a line of 2^23 + 1 nodes), so the
port solves with a hand-written CUDA kernel, ``thomas_solve`` in
``csrc/thomas.cu``, one thread per line, rounding exactly as the
reference's compiled scans do (its note says how, and what bounds it).

:func:`thomas_solve` launches the kernel for CUDA tensors and runs the plain
version :func:`repro_torch.kernels.ref.thomas_solve_ref` for CPU tensors;
for any other device it raises.  The forward sweep's factors depend only on
the line length; :func:`thomas_factors` computes them once per length and
device (on the card with the one-thread kernel ``thomas_factors``) and
keeps the last 256.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.device import F64
from repro_torch.kernels import build, ref


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=256)
def _factors(n: int, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if device.type == "cpu":
        return ref.thomas_factors_ref(n)
    if device.type == "cuda":
        cp = torch.empty(n, dtype=F64, device=device)
        denom = torch.empty(n, dtype=F64, device=device)
        lib = build.load("thomas")
        with torch.cuda.device(device):
            status = lib.thomas_factors(n, cp.data_ptr(), denom.data_ptr(),
                                        _stream(device))
        build.check(status, "thomas_factors")
        thomas_factors.launches += 1
        return cp, denom
    raise ValueError(f"thomas_factors: unsupported device {device}")


def thomas_factors(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cp, denom), each (n,) float64 on ``device``, computed once per
    length and device."""
    return _factors(n, torch.device(device))


thomas_factors.launches = 0


def _check(b: torch.Tensor, ax: int) -> None:
    if b.dtype != F64:
        raise TypeError(f"thomas_solve: b must be float64, got {b.dtype}")
    if not -b.dim() <= ax < b.dim():
        raise ValueError(f"thomas_solve: axis {ax} out of range for "
                         f"{tuple(b.shape)}")
    if b.numel() == 0:
        raise ValueError("thomas_solve: empty input")


def thomas_solve_plain(b: torch.Tensor, ax: int) -> torch.Tensor:
    """Plain version of the kernel (same contract)."""
    _check(b, ax)
    cp, denom = thomas_factors(b.shape[ax], torch.device("cpu"))
    return ref.thomas_solve_ref(b, ax, cp, denom)


def thomas_solve(b: torch.Tensor, ax: int) -> torch.Tensor:
    """Solve M z = b along axis ``ax`` of the float64 tensor ``b`` for every
    line, M = tridiag(1/3, d, 1/3), d = 2/3 at the ends and 4/3 inside."""
    if b.device.type == "cpu":
        return thomas_solve_plain(b, ax)
    if b.device.type != "cuda":
        raise ValueError(f"thomas_solve: unsupported device {b.device}")
    _check(b, ax)
    ax %= b.dim()
    b = b.contiguous()
    n = b.shape[ax]
    pre = math.prod(b.shape[:ax])
    post = math.prod(b.shape[ax + 1:])
    cp, denom = thomas_factors(n, b.device)
    out = torch.empty_like(b)
    lib = build.load("thomas")
    with torch.cuda.device(b.device):
        status = lib.thomas_solve(b.data_ptr(), cp.data_ptr(),
                                  denom.data_ptr(), pre, n, post,
                                  out.data_ptr(), _stream(b.device))
    build.check(status, "thomas_solve")
    thomas_solve.launches += 1
    return out


thomas_solve.launches = 0
