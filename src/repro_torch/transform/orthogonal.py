"""PMGARD-OB: multilevel decomposition with MGARD's L² projection, on
tensors.

Counterpart of ``repro/transform/orthogonal.py``.  After each level's
hierarchical surplus, the coarse nodal values receive the L² projection
correction z = M⁻¹ b of the detail, which couples the levels, so the L-inf
bound amplifies surplus errors through the projection:

    |x - x̂|_inf <= Σ_l (1 + κ) e_l + e_base,   κ = 3^d.

Weights (uniform fine spacing h=1, coarse H=2, piecewise-linear elements):
  load    b_i = 5/12 v_{2i}·(interior ×2) + 1/2 (v_{2i±1}) + 1/12 (v_{2i±2})
  mass    M = tridiag(1/3, 4/3, 1/3), boundary diagonal 2/3,
applied separably along each axis.

Bit-identical to the reference's compiled transform (``decompose_ob`` and
``recompose_ob`` are ``jax.jit``'d there).  XLA's CPU backend fuses each
multiply whose only use is an add into one fused multiply-add (ROADMAP
C3): in the load vector the two ``1/12`` terms (the ``1/2`` and ``5/12``
products are exact or rounded on their own), and in the Thomas sweeps every
``x - y·w``.  The load vector calls :func:`repro_torch.kernels.fma.fma` at
those two places; the sweeps run in :func:`repro_torch.kernels.thomas.
thomas_solve`, a CUDA kernel on the card.  The interpolation's products are
by 1/2, exact, so the hb helpers serve unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fma import fma
from repro_torch.kernels.thomas import thomas_solve
from repro_torch.transform.hierarchical import (
    _node_mask,
    _view_slices,
    interp_up,
)

# Per-axis amplification of surplus error through the projection.
KAPPA_PER_AXIS = 3.0


def ob_kappa(ndim: int) -> float:
    return KAPPA_PER_AXIS ** ndim


def _load_axis(v: torch.Tensor, ax: int) -> torch.Tensor:
    """b_i = Σ_j w_{ij} v_j with the piecewise-linear overlap weights, in
    the reference's order of updates."""
    v = v.movedim(ax, -1)
    m = (v.shape[-1] - 1) // 2
    even = v[..., 0::2]
    odd = v[..., 1::2]
    side = torch.full((m + 1,), 2.0, dtype=v.dtype, device=v.device)
    side[0] = side[-1] = 1.0
    b = (5.0 / 12.0) * even * side
    if m >= 1:
        b[..., :-1] += 0.5 * odd
        b[..., 1:] += 0.5 * odd
        b[..., :-1] = fma(1.0 / 12.0, even[..., 1:], b[..., :-1])
        b[..., 1:] = fma(1.0 / 12.0, even[..., :-1], b[..., 1:])
    return b.movedim(-1, ax)


def _thomas_axis(b: torch.Tensor, ax: int) -> torch.Tensor:
    """Solve M z = b along ``ax``, M = tridiag(1/3, diag, 1/3), diag 4/3
    inside and 2/3 at the boundary (a line of one node: b / (2/3))."""
    return thomas_solve(b.contiguous(), ax)


def project_detail(detail: torch.Tensor) -> torch.Tensor:
    """Tensor-product L² projection of the fine-grid detail onto the coarse
    grid: load, then mass-solve, along every axis."""
    z = detail
    for ax in range(detail.dim()):
        z = _thomas_axis(_load_axis(z, ax), ax)
    return z


def decompose_ob(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Levels fine -> coarse; each level's coarse nodes take the projection
    of its detail.  ``x`` is not modified."""
    x = x.clone()
    for l in range(levels):
        sl = _view_slices(x.dim(), 1 << l)
        view = x[sl]
        coarse = view[_view_slices(x.dim(), 2)]
        mask = _node_mask(tuple(view.shape), x.device)
        detail = torch.where(mask, view - interp_up(coarse), 0.0)
        new_view = torch.where(mask, detail, view)
        new_view[_view_slices(x.dim(), 2)] = coarse + project_detail(detail)
        x[sl] = new_view
    return x


def recompose_ob(c: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`decompose_ob`, coarse -> fine.  ``c`` is not
    modified."""
    c = c.clone()
    for l in range(levels - 1, -1, -1):
        sl = _view_slices(c.dim(), 1 << l)
        view = c[sl]
        mask = _node_mask(tuple(view.shape), c.device)
        detail = torch.where(mask, view, 0.0)
        coarse = view[_view_slices(c.dim(), 2)] - project_detail(detail)
        new_view = torch.where(mask, detail + interp_up(coarse), view)
        new_view[_view_slices(c.dim(), 2)] = coarse
        c[sl] = new_view
    return c


def ob_error_bound(level_bounds, base_bound: float, ndim: int) -> float:
    """OB L-inf bound: Σ_l (1+κ) e_l + e_base."""
    kappa = ob_kappa(ndim)
    return float((1.0 + kappa) * np.sum(level_bounds) + base_bound)
