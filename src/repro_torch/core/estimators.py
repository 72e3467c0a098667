"""Vectorised QoI error-bound estimators (paper §IV, Theorems 1-6), on
tensors.

Counterpart of ``repro/core/estimators.py``: every function maps
(reconstructed value(s), L-inf error bound(s)) to an upper bound on the
error of the QoI at the original values, elementwise, on the inputs'
device.  Guard violations (Thm 3 / Thm 6 preconditions) return +inf.

The op sequence follows the reference; integer powers use the repeated
products that ``jnp`` lowers ``x ** n`` to (:func:`ipow`), not
``torch.pow``, and square roots are correctly rounded (:func:`sqrt`).

Rounding as the reference's retrieval rounds (ROADMAP C3)
--------------------------------------------------------
The reference evaluates every QoI value and bound under ``jax.jit``
(``repro/core/retrieval.py::_estimate``).  XLA's CPU backend hands each
fused elementwise loop to LLVM, whose instruction selection turns an add
or subtract with an operand that is a multiply used nowhere else into one
fused multiply-add, rounded once.  Neither the optimised HLO nor the
optimised LLVM IR shows it.  The port reproduces it: a multiply whose only
use is an add stays open as a :class:`Product`, and :func:`add` fuses it
with :func:`repro_torch.kernels.fma.fma` (the CUDA kernel ``fma_rn`` on the
card, an exact emulation on the CPU).  Any other use rounds it first
(:func:`rounded`).  XLA also drops ``0 + x`` and ``1 * x`` before LLVM
sees them, so a product can meet an add across those identities;
``core/qoi.py`` follows that too.

When both operands of an add are such products, LLVM fuses the first
one, and which one is first is decided by LLVM's Reassociate pass: it
orders the operands by their rank, their distance from the loop body's
loads, so it depends on XLA's fusion boundaries and on the order in which
its emitter loads the inputs — not on the tree alone.  :func:`add` fuses
the left operand; ``bound_prod`` and ``bound_quot`` take the side as an
argument, which the expression nodes carry (``core/qoi.py``).  Their
defaults and ``core/ge.py``'s two exceptions are the placements of the
reference's CPU compile (jax 0.9.0), checked bit for bit by
``tests/test_torch_fma.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.kernels import fma as fma_kernel

Tensor = torch.Tensor
INF = math.inf


class Product(NamedTuple):
    """The product ``x * y``, not rounded yet: its only use is still to
    come, and if that is an add, the two are fused into one rounding."""
    x: Union[Tensor, float]
    y: Union[Tensor, float]


Value = Union[Tensor, Product]


def rounded(v: Value) -> Tensor:
    """``v`` as a tensor: a pending product is rounded on its own."""
    return v.x * v.y if isinstance(v, Product) else v


def add(p: Value, q: Union[Value, float]) -> Tensor:
    """``p + q`` as the reference's compiled graph rounds it: a pending
    product operand is fused into the add (the left one when both are)."""
    if isinstance(p, Product):
        return fma_kernel.fma(p.x, p.y, rounded(q))
    if isinstance(q, Product):
        return fma_kernel.fma(q.x, q.y, p)
    return p + q


def ipow(x: Tensor, n: int, pending: bool = False) -> Value:
    """x ** n for a static integer n >= 0 as the product ladder of
    ``lax.integer_pow`` (square-and-multiply, low bit first), so the
    rounding matches the reference.  The ladder's last multiply is the top
    power times the lower bits' product (or a squaring, for a power of
    two); ``pending=True`` leaves it as a :class:`Product`."""
    if n < 2:
        return torch.ones_like(x) if n == 0 else x
    top = 1 << (n.bit_length() - 1)
    if n == top:
        half = ipow(x, n // 2)
        p = Product(half, half)
    else:
        p = Product(ipow(x, n - top), ipow(x, top))
    return p if pending else rounded(p)


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
    safe_eps = _safe(eps)
    eps_pow = safe_eps * torch.ones(
        torch.broadcast_shapes(x.shape, eps.shape),
        dtype=torch.promote_types(x.dtype, eps.dtype), device=x.device)
    total = None
    for i in range(1, n + 1):
        if i > 1:
            eps_pow = Product(eps_pow, safe_eps)
            if i < n:
                eps_pow = rounded(eps_pow)
        # the last term is 1 * |x|^0 * ε^n: XLA drops the unit factors, so
        # its add meets the product ε^(n-1) * ε itself
        term = eps_pow if i == n else Product(
            math.comb(n, i) * ipow(ax, n - i), eps_pow)
        total = term if total is None else add(total, term)
    return _inf_guard([eps], rounded(total))


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


def bound_radical(x: Value, eps: Tensor, c: float) -> Tensor:
    """Theorem 3: f(x)=1/(x+c), Δ ≤ ε / { min(|x+c-ε|, |x+c+ε|) · |x+c| }.

    Requires ε < |x+c|; +inf otherwise (retrieval must tighten ε first).
    ``x`` may be a pending product: its only use is ``x + c``."""
    xc = add(x, c)
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


def _sum2(p: Product, q: Product, fuse_right: bool) -> Tensor:
    """``p + q`` with the right product fused instead of the left one."""
    return add(q, p) if fuse_right else add(p, q)


def bound_prod(x1: Tensor, eps1: Tensor, x2: Tensor, eps2: Tensor,
               fuse_right: bool = True) -> Tensor:
    """Theorem 5: g=x1·x2, Δ ≤ |x1|ε2 + |x2|ε1 + ε1ε2.  ``fuse_right``:
    which of the first two products the compiled reference fuses."""
    e1 = _safe(eps1)
    e2 = _safe(eps2)
    total = add(_sum2(Product(torch.abs(x1), e2), Product(torch.abs(x2), e1),
                      fuse_right), Product(e1, e2))
    return _inf_guard([eps1, eps2], total)


def bound_quot(x1: Tensor, eps1: Tensor, x2: Tensor, eps2: Tensor,
               fuse_right: bool = False) -> Tensor:
    """Theorem 6: g=x1/x2, Δ ≤ (|x1|ε2 + |x2|ε1) / {|x2| min(|x2-ε2|,|x2+ε2|)}.

    Requires ε2 < |x2|; +inf otherwise.  ``fuse_right`` as in
    :func:`bound_prod`."""
    e1 = _safe(eps1)
    e2 = _safe(eps2)
    ok = e2 < torch.abs(x2)
    denom = torch.abs(x2) * torch.minimum(torch.abs(x2 - e2),
                                          torch.abs(x2 + e2))
    good = ok & (denom > 0)
    num = _sum2(Product(torch.abs(x1), e2), Product(torch.abs(x2), e1),
                fuse_right)
    return _inf_guard([eps1, eps2],
                      torch.where(good, num / torch.where(good, denom, 1.0),
                                  INF))
