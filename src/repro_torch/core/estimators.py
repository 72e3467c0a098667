"""Vectorised QoI error-bound estimators (paper §IV, Theorems 1-6), on
tensors.

Counterpart of ``repro/core/estimators.py``: every function maps
(reconstructed value(s), L-inf error bound(s)) to an upper bound on the
error of the QoI at the original values, elementwise, on the inputs'
device.  Guard violations (Thm 3 / Thm 6 preconditions) return +inf.

The op sequence follows the reference; integer powers use the repeated
products that ``jnp`` lowers ``x ** n`` to (:func:`ipow`), not
``torch.pow``, and square roots are correctly rounded (:func:`sqrt`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor
INF = math.inf


def ipow(x: Tensor, n: int) -> Tensor:
    """x ** n for a static integer n >= 0 as the product ladder of
    ``lax.integer_pow`` (square-and-multiply, low bit first), so the
    rounding matches the reference."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def sqrt(x: Tensor) -> Tensor:
    """Correctly rounded float64 square root.  CUDA's is IEEE, as is the
    reference's; torch's CPU kernel can be one ulp off (a vectorised
    approximation), so CPU tensors take numpy's IEEE sqrt instead."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()), dtype=x.dtype)
    return torch.sqrt(x)


def _safe(eps: Tensor) -> Tensor:
    return torch.where(torch.isinf(eps), 0.0, eps)


def _inf_guard(eps_terms, finite_bound: Tensor) -> Tensor:
    """Propagate +inf child bounds without generating 0·inf = NaN: if any
    input bound is infinite the composite bound is infinite."""
    any_inf = torch.zeros_like(finite_bound, dtype=torch.bool)
    for e in eps_terms:
        any_inf = any_inf | torch.isinf(e)
    return torch.where(any_inf, INF, finite_bound)


# ---------------------------------------------------------------------------
# Univariate bases (Theorems 1-3)
# ---------------------------------------------------------------------------


def bound_intpow(x: Tensor, eps: Tensor, n: int) -> Tensor:
    """Theorem 1: f(x)=x^n, Δ ≤ Σ_{i=1..n} C(n,i) |x|^{n-i} ε^i  (n static)."""
    if n < 1:
        raise ValueError(f"intpow requires n >= 1, got {n}")
    ax = torch.abs(x)
    total = torch.zeros(torch.broadcast_shapes(x.shape, eps.shape),
                        dtype=torch.promote_types(x.dtype, eps.dtype),
                        device=x.device)
    safe_eps = _safe(eps)
    eps_pow = safe_eps * torch.ones_like(total)
    for i in range(1, n + 1):
        total = total + math.comb(n, i) * ipow(ax, n - i) * eps_pow
        eps_pow = eps_pow * safe_eps
    return _inf_guard([eps], total)


def bound_sqrt(x: Tensor, eps: Tensor, tight: bool = False) -> Tensor:
    """Theorem 2: f(x)=√x, Δ ≤ ε / (√max(x-ε, 0) + √x).

    ``tight=True`` uses the exact supremum over [max(x-ε,0), x+ε] instead of
    the paper's relaxation (finite at x=0)."""
    xc = torch.clamp_min(x, 0.0)
    safe_eps = _safe(eps)
    lo = sqrt(torch.clamp_min(xc - safe_eps, 0.0))
    if tight:
        hi = sqrt(xc + torch.clamp_min(safe_eps, 0.0))
        sx = sqrt(xc)
        return _inf_guard([eps], torch.maximum(sx - lo, hi - sx))
    denom = lo + sqrt(xc)
    out = torch.where(denom > 0,
                      safe_eps / torch.where(denom > 0, denom, 1.0), INF)
    # exact inputs (ε = 0) have exactly zero QoI error even at x = 0
    return _inf_guard([eps], torch.where(eps <= 0, 0.0, out))


def bound_radical(x: Tensor, eps: Tensor, c: float) -> Tensor:
    """Theorem 3: f(x)=1/(x+c), Δ ≤ ε / { min(|x+c-ε|, |x+c+ε|) · |x+c| }.

    Requires ε < |x+c|; +inf otherwise (retrieval must tighten ε first)."""
    xc = x + c
    safe_eps = _safe(eps)
    ok = safe_eps < torch.abs(xc)
    denom = torch.minimum(torch.abs(xc - safe_eps), torch.abs(xc + safe_eps)) \
        * torch.abs(xc)
    good = ok & (denom > 0)
    out = torch.where(good, safe_eps / torch.where(good, denom, 1.0), INF)
    return _inf_guard([eps], out)


def bound_log(x: Tensor, eps: Tensor) -> Tensor:
    """Beyond-paper basis: f(x)=ln(x), Δ ≤ ln(x / (x-ε)) for ε < x; +inf
    when ε >= x."""
    safe_eps = _safe(eps)
    ok = (x > 0) & (safe_eps < x)
    denom = torch.where(ok, x - safe_eps, 1.0)
    out = torch.where(ok, torch.log(torch.where(ok, x, 1.0) / denom), INF)
    return _inf_guard([eps], torch.where(
        eps <= 0, torch.where(ok, 0.0, INF), out))


# ---------------------------------------------------------------------------
# Multivariate bases (Theorems 4-6)
# ---------------------------------------------------------------------------


def bound_sum(coeffs, eps_list) -> Tensor:
    """Theorem 4: g(x)=Σ a_i x_i, Δ ≤ Σ |a_i| ε_i."""
    total = 0.0
    for a, e in zip(coeffs, eps_list):
        total = total + abs(a) * e
    return torch.as_tensor(total, dtype=torch.float64)


def bound_prod(x1: Tensor, eps1: Tensor, x2: Tensor, eps2: Tensor) -> Tensor:
    """Theorem 5: g=x1·x2, Δ ≤ |x1|ε2 + |x2|ε1 + ε1ε2."""
    e1 = _safe(eps1)
    e2 = _safe(eps2)
    return _inf_guard([eps1, eps2],
                      torch.abs(x1) * e2 + torch.abs(x2) * e1 + e1 * e2)


def bound_quot(x1: Tensor, eps1: Tensor, x2: Tensor, eps2: Tensor) -> Tensor:
    """Theorem 6: g=x1/x2, Δ ≤ (|x1|ε2 + |x2|ε1) / {|x2| min(|x2-ε2|,|x2+ε2|)}.

    Requires ε2 < |x2|; +inf otherwise."""
    e1 = _safe(eps1)
    e2 = _safe(eps2)
    ok = e2 < torch.abs(x2)
    denom = torch.abs(x2) * torch.minimum(torch.abs(x2 - e2),
                                          torch.abs(x2 + e2))
    good = ok & (denom > 0)
    num = torch.abs(x1) * e2 + torch.abs(x2) * e1
    return _inf_guard([eps1, eps2],
                      torch.where(good, num / torch.where(good, denom, 1.0),
                                  INF))
