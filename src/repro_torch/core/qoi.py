"""Composable QoI expressions with guaranteed error-bound propagation, on
tensors.

Counterpart of ``repro/core/qoi.py``.  Each node evaluates to ``(value,
bound)``: the QoI on the *reconstructed* data and a guaranteed upper bound
on ``|QoI(original) - QoI(reconstructed)|`` given per-variable L-inf bounds.
Composition implements paper Theorems 7-9 structurally: a parent applies
its base estimator (estimators.py) to each child's ``bound``.

Evaluation is eager torch on the device of the values given (numpy arrays
are taken as CPU tensors); the op order follows the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core import estimators as est
from repro_torch.device import F64

Tensor = torch.Tensor
ValueBound = Tuple[Tensor, Tensor]


def _device(values: Dict[str, object]) -> torch.device:
    for v in values.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class Expr:
    """Base class of derivable-QoI expression nodes."""

    def eval(self, values: Dict[str, Tensor],
             ebs: Dict[str, Tensor]) -> ValueBound:
        raise NotImplementedError

    def variables(self) -> frozenset:
        raise NotImplementedError

    def value(self, values: Dict[str, Tensor]) -> Tensor:
        """Ground-truth evaluation (no error bounds) — used for oracles."""
        zeros = {k: torch.zeros_like(torch.as_tensor(v))
                 for k, v in values.items()}
        return self.eval(values, zeros)[0]

    # Operator sugar -------------------------------------------------------
    def __add__(self, other):
        return Sum([self, _lift(other)])

    def __radd__(self, other):
        return Sum([_lift(other), self])

    def __mul__(self, other):
        other = _lift(other)
        if isinstance(other, Const):
            return Sum([self], coeffs=[other.c])
        return Prod(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __sub__(self, other):
        other = _lift(other)
        if isinstance(other, Const):
            return Sum([self, Const(-other.c)])
        return Sum([self, other], coeffs=[1.0, -1.0])

    def __truediv__(self, other):
        other = _lift(other)
        if isinstance(other, Const):
            return Sum([self], coeffs=[1.0 / other.c])
        return Quot(self, other)


def _lift(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    return Const(float(x))


@dataclass(frozen=True)
class Var(Expr):
    """A primary data field; (value, bound) come straight from retrieval."""
    name: str

    def eval(self, values, ebs):
        v = torch.as_tensor(values[self.name])
        e = torch.broadcast_to(
            torch.as_tensor(ebs[self.name], dtype=F64, device=v.device),
            v.shape)
        return v, e

    def variables(self):
        return frozenset({self.name})


@dataclass(frozen=True)
class Const(Expr):
    c: float

    def eval(self, values, ebs):
        dev = _device(values)
        return (torch.tensor(self.c, dtype=F64, device=dev),
                torch.tensor(0.0, dtype=F64, device=dev))

    def variables(self):
        return frozenset()


@dataclass(frozen=True)
class Sum(Expr):
    """Weighted sum Σ a_i child_i + const  (Thms 4, 7, 8)."""
    children: Sequence[Expr]
    coeffs: Sequence[float] = None
    const: float = 0.0

    def __post_init__(self):
        # tuples so expressions hash structurally
        object.__setattr__(self, "children", tuple(self.children))
        if self.coeffs is not None:
            object.__setattr__(self, "coeffs", tuple(self.coeffs))

    def eval(self, values, ebs):
        coeffs = self.coeffs if self.coeffs is not None else [1.0] * len(self.children)
        dev = _device(values)
        val = torch.tensor(self.const, dtype=F64, device=dev)
        bnd = torch.tensor(0.0, dtype=F64, device=dev)
        for a, ch in zip(coeffs, self.children):
            cv, cb = ch.eval(values, ebs)
            val = val + a * cv
            bnd = bnd + abs(a) * cb
        return val, bnd

    def variables(self):
        out = frozenset()
        for ch in self.children:
            out |= ch.variables()
        return out


@dataclass(frozen=True)
class Prod(Expr):
    """Binary product (Thm 5). Use repeated Prod for Π x_i (Thm 5 + Thm 9)."""
    a: Expr
    b: Expr

    def eval(self, values, ebs):
        av, ab = self.a.eval(values, ebs)
        bv, bb = self.b.eval(values, ebs)
        return av * bv, est.bound_prod(av, ab, bv, bb)

    def variables(self):
        return self.a.variables() | self.b.variables()


@dataclass(frozen=True)
class Quot(Expr):
    """Quotient a/b (Thm 6); bound is +inf until ε_b < |b|."""
    a: Expr
    b: Expr

    def eval(self, values, ebs):
        av, ab = self.a.eval(values, ebs)
        bv, bb = self.b.eval(values, ebs)
        safe = torch.where(bv == 0, 1.0, bv)
        val = torch.where(bv == 0, 0.0, av / safe)
        return val, est.bound_quot(av, ab, bv, bb)

    def variables(self):
        return self.a.variables() | self.b.variables()


@dataclass(frozen=True)
class IntPow(Expr):
    """child^n for integer n >= 1 (Thm 1 composed via Thm 9)."""
    child: Expr
    n: int

    def eval(self, values, ebs):
        cv, cb = self.child.eval(values, ebs)
        return est.ipow(cv, self.n), est.bound_intpow(cv, cb, self.n)

    def variables(self):
        return self.child.variables()


@dataclass(frozen=True)
class Sqrt(Expr):
    """√child (Thm 2 composed via Thm 9). Values are clamped to [0, inf):
    the true value of a physically non-negative argument lies in [0, v+ε],
    so the clamp removes a reconstruction artefact without weakening the
    bound."""
    child: Expr
    tight: bool = False

    def eval(self, values, ebs):
        cv, cb = self.child.eval(values, ebs)
        cv = torch.clamp_min(cv, 0.0)
        return est.sqrt(cv), est.bound_sqrt(cv, cb, tight=self.tight)

    def variables(self):
        return self.child.variables()


@dataclass(frozen=True)
class Radical(Expr):
    """1/(child + c) (Thm 3 composed via Thm 9)."""
    child: Expr
    c: float = 0.0

    def eval(self, values, ebs):
        cv, cb = self.child.eval(values, ebs)
        xc = cv + self.c
        safe = torch.where(xc == 0, 1.0, xc)
        val = torch.where(xc == 0, 0.0, 1.0 / safe)
        return val, est.bound_radical(cv, cb, self.c)

    def variables(self):
        return self.child.variables()


@dataclass(frozen=True)
class Log(Expr):
    """ln(child) — beyond-paper basis (estimators.bound_log)."""
    child: Expr

    def eval(self, values, ebs):
        cv, cb = self.child.eval(values, ebs)
        safe = torch.clamp_min(cv, 1e-300)
        return torch.log(safe), est.bound_log(cv, cb)

    def variables(self):
        return self.child.variables()


# ---------------------------------------------------------------------------
# Convenience builders
# ---------------------------------------------------------------------------


def scale(e: Expr, a: float, const: float = 0.0) -> Expr:
    return Sum([e], coeffs=[a], const=const)


def square(e: Expr) -> Expr:
    return IntPow(e, 2)


def magnitude(parts: Sequence[Expr], tight: bool = False) -> Expr:
    """sqrt(Σ e_i²) — e.g. total velocity (paper Eq. 1 / §IV-D)."""
    return Sqrt(Sum([square(p) for p in parts]), tight=tight)


def frac_pow(e: Expr, p: float, tight: bool = False) -> Expr:
    """e^p for p = k + m/2 (k int >= 0, m in {0, 1}), via x^k·√x compositions.

    Covers the paper's exponents: 1.5 (mu, Eq 6) and 3.5 (PT, Eq 5)."""
    k = int(p)
    frac = p - k
    if abs(frac) < 1e-12:
        return IntPow(e, k) if k != 1 else e
    if abs(frac - 0.5) > 1e-12:
        raise ValueError(f"frac_pow supports half-integer exponents, got {p}")
    root = Sqrt(e, tight=tight)
    if k == 0:
        return root
    return Prod(IntPow(e, k) if k > 1 else e, root)
