"""Batched Thomas solve of the ob transform's L² projection.

No Pallas kernel of the reference computes this: it is the jnp graph
``repro/transform/orthogonal.py::_thomas_axis``, two ``lax.scan`` over the
nodes of every line along one axis.  A torch op per node is not viable on
the card (a 1-D field of 2^24 points has a line of 2^23 + 1 nodes), so the
port solves with a hand-written CUDA kernel, ``thomas_solve`` in
``csrc/thomas.cu``, rounding exactly as the reference's compiled scans do
(its note says how, and what bounds it).

:func:`thomas_solve` launches the kernel for CUDA tensors and runs the plain
version :func:`repro_torch.kernels.ref.thomas_solve_ref` for CPU tensors;
for any other device it raises.  The forward sweep's factors depend only on
the line length, and past a few nodes not even on that: :func:`factor_table`
runs their recurrence on the host until it reaches its fixed point and
gives the kernel a few rows (denominator, its reciprocal, cp), uploaded
once per device and table (:func:`thomas_table`).  :func:`thomas_factors`
expands the rows to the n-long factors of the plain version.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch

from repro_torch.device import F64
from repro_torch.kernels import build, ref

_END, _INNER = 2.0 / 3.0, 4.0 / 3.0


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _sequence() -> Tuple[Tuple[float, float], ...]:
    """(denom, cp) of node 0 and of interior nodes 1, 2, … up to the first
    interior entry that equals its predecessor bit for bit: the last entry
    is the fixed point that every later interior node takes."""
    seq: List[Tuple[float, float]] = []
    c = 0.0
    while True:
        den = ref.fma_scalar(-ref.THOMAS_OFF, c, _END if not seq else _INNER)
        c = ref.THOMAS_OFF / den
        if len(seq) >= 2 and (den, c) == seq[-1]:
            return tuple(seq)
        seq.append((den, c))
        if len(seq) > 1000:
            raise RuntimeError("thomas factors: no fixed point in 1000 steps")


def fixed_index() -> int:
    """K: the first node index whose interior factors equal every later
    interior node's."""
    return len(_sequence()) - 1


def factor_table(n: int) -> Tuple[List[Tuple[float, float, float]], int]:
    """Rows (denom, RN(1/denom), cp) of an n-node line and h = min(K, n-1):
    row i for node i < h, row h for nodes h..n-2, row h+1 for node n-1."""
    if n < 1:
        raise ValueError(f"thomas factors: n must be >= 1, got {n}")
    seq = _sequence()
    h = min(len(seq) - 1, n - 1)
    rows = [seq[i] for i in range(h + 1)]
    c_prev = seq[min(n - 2, h)][1] if n >= 2 else 0.0
    den = ref.fma_scalar(-ref.THOMAS_OFF, c_prev, _END)
    rows.append((den, ref.THOMAS_OFF / den))
    return [(d, 1.0 / d, c) for d, c in rows], h


def thomas_factors(n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cp, denom), each (n,) float64 on the CPU, expanded from
    :func:`factor_table`; equal to ``ref.thomas_factors_ref(n)``."""
    rows, h = factor_table(n)
    cp = torch.full((n,), rows[h][2], dtype=F64)
    denom = torch.full((n,), rows[h][0], dtype=F64)
    cp[:h] = torch.tensor([r[2] for r in rows[:h]], dtype=F64)
    denom[:h] = torch.tensor([r[0] for r in rows[:h]], dtype=F64)
    cp[n - 1], denom[n - 1] = rows[h + 1][2], rows[h + 1][0]
    return cp, denom


@functools.lru_cache(maxsize=64)
def _device_table(key: int, device: torch.device) -> Tuple[torch.Tensor, int]:
    rows, h = factor_table(key)
    flat = [v for row in rows for v in row]
    return torch.tensor(flat, dtype=F64, device=device), h


def thomas_table(n: int, device) -> Tuple[torch.Tensor, int]:
    """The kernel's factor table of an n-node line on ``device`` and its h.
    Every n >= K + 2 has the same table, so one upload serves them all."""
    return _device_table(min(n, fixed_index() + 2), torch.device(device))


def _check(b: torch.Tensor, ax: int) -> None:
    if b.dtype != F64:
        raise TypeError(f"thomas_solve: b must be float64, got {b.dtype}")
    if not -b.dim() <= ax < b.dim():
        raise ValueError(f"thomas_solve: axis {ax} out of range for "
                         f"{tuple(b.shape)}")
    if b.numel() == 0:
        raise ValueError("thomas_solve: empty input")


@functools.lru_cache(maxsize=64)
def _plain_factors(n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.thomas_factors_ref(n)


def thomas_solve_plain(b: torch.Tensor, ax: int) -> torch.Tensor:
    """Plain version of the kernel (same contract)."""
    _check(b, ax)
    return ref.thomas_solve_ref(b, ax, *_plain_factors(b.shape[ax]))


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
    if pre * post == 1 and b.data_ptr() % 16:
        b = b.clone()               # the one-line kernel's bulk copies
    table, h = thomas_table(n, b.device)
    out = torch.empty_like(b)
    lib = build.load("thomas")
    with torch.cuda.device(b.device):
        status = lib.thomas_solve(b.data_ptr(), table.data_ptr(), h, pre, n,
                                  post, out.data_ptr(), _stream(b.device))
    build.check(status, "thomas_solve")
    thomas_solve.launches += 1
    return out


thomas_solve.launches = 0
