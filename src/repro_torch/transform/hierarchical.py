"""PMGARD-HB multilevel decomposition (paper §V-B), on tensors.

Counterpart of ``repro/transform/hierarchical.py`` for the hb method and
the ip method's truncated contributions.  The grid helpers are numpy, copied
as they are but for ``_v2`` (one pass, the same values); the transform runs
as plain torch ops on the tensor's device, with the reference's op sequence kept
exactly (``mid = 0.5 * (lo + hi)``, then ``view - pred`` / ``view + pred``,
then ``where(mask, ...)``) and no fused ops that could contract into an FMA.
Every op is elementwise IEEE float64, so results are bit-identical to the
JAX package on any device.

Unlike the reference's functional ``.at[].set``, the steps update a tensor
the function owns in place; inputs are never modified.  The reference's
vmapped batch entry points (``*_from_batch``, the serve plane's batched
tick) take a leading batch axis written out: the same elementwise ops over
one more dimension, so each slice is bit-equal to the solo function.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Grid geometry (numpy, as in the reference)
# ---------------------------------------------------------------------------


def _pad_dim(n: int) -> int:
    """Smallest 2^k + 1 >= n (k >= 0)."""
    if n <= 2:
        return 2 if n == 1 else 3  # degenerate dims get a tiny valid grid
    k = int(np.ceil(np.log2(n - 1)))
    return (1 << k) + 1


def pad_to_grid(x: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Edge-replicate pad every dim to 2^k + 1. Returns (padded, orig_shape)."""
    orig = x.shape
    target = tuple(_pad_dim(n) for n in orig)
    pads = tuple((0, t - n) for t, n in zip(target, orig))
    return np.pad(x, pads, mode="edge"), orig


def unpad(x, orig_shape: Tuple[int, ...]):
    return x[tuple(slice(0, n) for n in orig_shape)]


def grid_levels(shape: Tuple[int, ...], max_levels: int = 32) -> int:
    """Number of detail levels supported by a padded (2^k+1, ...) grid."""
    ks = []
    for n in shape:
        k = int(np.round(np.log2(n - 1))) if n > 2 else 0
        ks.append(k)
    return min(min(ks), max_levels)


def level_map(shape: Tuple[int, ...], levels: int) -> np.ndarray:
    """Per-node detail level: l in [0, levels) for detail nodes (finest = 0),
    ``levels`` for base-grid nodes. Level of node i = min over dims of the
    2-adic valuation of its coordinates, clipped to the base grid."""
    val = np.full(shape, levels, dtype=np.int32)
    for ax, n in enumerate(shape):
        idx = np.arange(n)
        v2 = np.full(n, levels, dtype=np.int32)
        nz = idx != 0
        v2[nz] = np.minimum(_v2(idx[nz]), levels)
        sl = [None] * len(shape)
        sl[ax] = slice(None)
        val = np.minimum(val, v2[tuple(sl)])
    return val


def _v2(idx: np.ndarray) -> np.ndarray:
    """2-adic valuation of positive ints, vectorised: the exponent of the
    lowest set bit ``idx & -idx``, a power of two that float64 holds
    exactly and ``frexp`` returns as 0.5 · 2^(k+1).  One pass, where the
    reference halves the even entries until none is left (a pass per
    level, ~9 s for a 2^24+1-node grid on the chip machine's host)."""
    idx = np.asarray(idx, dtype=np.int64)
    low = (idx & -idx).astype(np.float64)
    return (np.frexp(low)[1] - 1).astype(np.int32)


def _new_node_mask(shape: Tuple[int, ...]) -> np.ndarray:
    """Nodes of the fine view NOT on the 2-strided coarse grid."""
    m = np.zeros(shape, dtype=bool)
    for ax, n in enumerate(shape):
        odd = (np.arange(n) % 2).astype(bool)
        sl = [None] * len(shape)
        sl[ax] = slice(None)
        m |= odd[tuple(sl)]
    return m


@functools.lru_cache(maxsize=256)
def _node_mask(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``_new_node_mask`` on ``device``, built once per view shape (a
    recompose from level l revisits the views of every finer level)."""
    return torch.from_numpy(_new_node_mask(shape)).to(device)


def _view_slices(ndim: int, stride: int, lead: int = 0):
    """Strided view of the last ``ndim`` axes, behind ``lead`` batch axes."""
    return (slice(None),) * lead + tuple(slice(None, None, stride)
                                         for _ in range(ndim))


# ---------------------------------------------------------------------------
# Multilinear upsampling (coarse grid -> fine grid prediction)
# ---------------------------------------------------------------------------


def _up_axis(c: torch.Tensor, ax: int) -> torch.Tensor:
    """Linear-interpolate a (2m+1 -> from m+1) refinement along one axis."""
    n = c.shape[ax]
    out_shape = tuple(c.shape[:ax]) + (2 * n - 1,) + tuple(c.shape[ax + 1:])
    lo = c.narrow(ax, 0, n - 1)
    hi = c.narrow(ax, 1, n - 1)
    mid = 0.5 * (lo + hi)
    out = torch.zeros(out_shape, dtype=c.dtype, device=c.device)
    even = tuple(slice(None) if i != ax else slice(0, None, 2)
                 for i in range(c.dim()))
    odd = tuple(slice(None) if i != ax else slice(1, None, 2)
                for i in range(c.dim()))
    out[even] = c
    out[odd] = mid
    return out


def interp_up(coarse: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Multilinear prediction of the fine grid from the coarse grid (the
    axes behind ``lead`` batch axes)."""
    out = coarse
    for ax in range(lead, coarse.dim()):
        out = _up_axis(out, ax)
    return out


# ---------------------------------------------------------------------------
# HB decompose / recompose
# ---------------------------------------------------------------------------


def decompose_hb(x: torch.Tensor, levels: int) -> torch.Tensor:
    """In-place-layout HB transform: detail nodes hold surpluses, base nodes
    hold original values. Levels are independent (no cross-level coupling)."""
    x = x.clone()
    for l in range(levels):
        sl = _view_slices(x.dim(), 1 << l)
        view = x[sl]
        pred = interp_up(view[_view_slices(x.dim(), 2)])
        mask = _node_mask(tuple(view.shape), x.device)
        x[sl] = torch.where(mask, view - pred, view)
    return x


def _recompose_steps(c: torch.Tensor, start: int,
                     lead: int = 0) -> torch.Tensor:
    """Recompose steps start..0 (coarse -> fine) in place on ``c`` (a grid
    behind ``lead`` batch axes), shared by every entry point so all produce
    bitwise-identical results."""
    ndim = c.dim() - lead
    for l in range(start, -1, -1):
        sl = _view_slices(ndim, 1 << l, lead)
        view = c[sl]
        pred = interp_up(view[_view_slices(ndim, 2, lead)], lead)
        mask = _node_mask(tuple(view.shape[lead:]), c.device)
        c[sl] = torch.where(mask, view + pred, view)
    return c


def recompose_hb(c: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of decompose_hb; must run coarse -> fine."""
    return _recompose_steps(c.clone(), levels - 1)


def recompose_hb_from(c: torch.Tensor, levels: int,
                      start: int) -> torch.Tensor:
    """Partial recompose: only steps start..0.  For a coefficient field
    supported on levels <= start this is bitwise identical to the full
    recompose (the skipped coarse steps see an all-zero view)."""
    return _recompose_steps(c.clone(), min(start, levels - 1))


def scatter_recompose_from(idx: torch.Tensor, vals: torch.Tensor,
                           shape: Tuple[int, ...], levels: int,
                           start: int) -> torch.Tensor:
    """Scatter one level's decoded values (flat node indices ``idx``, all
    distinct) into a zero field and partially recompose it — the reader's
    per-level contribution, computed where ``vals`` lives."""
    field = torch.zeros(int(np.prod(shape)), dtype=vals.dtype,
                        device=vals.device)
    field.index_copy_(0, idx, vals)
    return _recompose_steps(field.reshape(shape), min(start, levels - 1))


def scatter_recompose_from_batch(idx: torch.Tensor, vals: torch.Tensor,
                                 shape: Tuple[int, ...], levels: int,
                                 start: int) -> torch.Tensor:
    """:func:`scatter_recompose_from` over a leading batch axis: ``idx`` and
    ``vals`` (B, n) -> (B, *shape), slice b bit-equal to the solo call on
    ``idx[b], vals[b]`` (the serve plane's batched recompose of B readers'
    same-shaped contributions)."""
    field = torch.zeros((vals.shape[0], int(np.prod(shape))),
                        dtype=vals.dtype, device=vals.device)
    field.scatter_(1, idx, vals)
    return _recompose_steps(field.reshape(vals.shape[0], *shape),
                            min(start, levels - 1), lead=1)


def hb_error_bound(level_bounds: List[float]) -> float:
    """HB L-inf bound: Σ_l e_l (+ base bound, passed as last entry)."""
    return float(np.sum(level_bounds))


# ---------------------------------------------------------------------------
# Interpolation-predicted (`ip`) representation
# ---------------------------------------------------------------------------
#
# The ip method codes each group's residual against the decoder's own
# truncated reconstruction of all coarser groups.  Group g records
# ``pred_planes`` (kp_g); the decoder's contribution of group g is
#
#     C_g = recompose_hb_from(scatter(T_g), levels, start=g)      (truncated
#     C_g.ravel()[idx_g] += v̂_g - T_g                              + tail)
#
# with T_g = trunc(v̂_g, 2^{E_g - kp_g}).  Truncation to a power-of-two
# quantum is exact in float64, and the identity for fetched depths k <= kp.
# When every group is fetched to k_g >= kp_g the decoder's prediction
# replays the encoder's bit for bit and the bound is max_g e_g; under-
# fetched groups add δ_g = 2^{E-k} - 2^{E-kp} to the finer groups' bound
# (``ip_error_bound``).


def _sign(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: ±1, and a zero keeps its own sign."""
    return torch.where(v == 0, v, torch.sign(v))


def trunc_to_quantum(v: torch.Tensor, quantum: float) -> torch.Tensor:
    """sign(v)·floor(|v|/q)·q — truncate toward zero to multiples of the
    power-of-two quantum ``q``; exact in float64 (|v| is an integer
    multiple m·q with m < 2^53).  ``q == 0`` is the identity."""
    if quantum == 0.0:
        return v
    return _sign(v) * torch.floor(torch.abs(v) / quantum) * quantum


def scatter_recompose_ip_from(idx: torch.Tensor, vals: torch.Tensor,
                              shape: Tuple[int, ...], levels: int,
                              start: int, quantum: float) -> torch.Tensor:
    """ip counterpart of :func:`scatter_recompose_from`: truncate the
    decoded values to the group's prediction quantum, scatter and partially
    recompose the truncated part, then add the truncation tail back at the
    group's own nodes (an exact no-op add of zeros when nothing was
    truncated, as in the reference)."""
    t = trunc_to_quantum(vals, quantum)
    field = torch.zeros(int(np.prod(shape)), dtype=vals.dtype,
                        device=vals.device)
    field.index_copy_(0, idx, t)
    out = _recompose_steps(field.reshape(shape), min(start, levels - 1))
    out.view(-1).index_add_(0, idx, vals - t)
    return out


def scatter_recompose_ip_from_batch(idx: torch.Tensor, vals: torch.Tensor,
                                    shape: Tuple[int, ...], levels: int,
                                    start: int,
                                    quantum: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_recompose_ip_from` over a leading batch axis, with one
    quantum per item (``quantum`` (B,) float64 on ``vals``' device; 0.0 for
    no truncation); slice b is bit-equal to the solo call."""
    q = quantum.to(vals.dtype).reshape(-1, 1)
    safe = torch.where(q == 0.0, torch.ones_like(q), q)
    t = torch.where(q == 0.0, vals,
                    _sign(vals) * torch.floor(torch.abs(vals) / safe) * safe)
    nb = vals.shape[0]
    field = torch.zeros((nb, int(np.prod(shape))), dtype=vals.dtype,
                        device=vals.device)
    field.scatter_(1, idx, t)
    out = _recompose_steps(field.reshape(nb, *shape),
                           min(start, levels - 1), lead=1)
    out.view(nb, -1).scatter_add_(1, idx, vals - t)
    return out


def ip_error_bound(level_bounds: List[float],
                   mismatches: List[float]) -> float:
    """ip L-inf bound, lists finest-first (last entry = base group): walking
    coarse -> fine with the running mismatch m, max_g (e_g + m_g), m_g =
    Σ_{g' coarser than g} δ_{g'}.  Always <= the hb bound."""
    out = 0.0
    m = 0.0
    for e, d in zip(reversed(level_bounds), reversed(mismatches)):
        out = max(out, float(e) + m)
        m += float(d)
    return float(out)
