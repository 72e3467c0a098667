"""Composable QoI expressions with guaranteed error-bound propagation, on
tensors.

Counterpart of ``repro/core/qoi.py``.  Each node evaluates to ``(value,
bound)``: the QoI on the *reconstructed* data and a guaranteed upper bound
on ``|QoI(original) - QoI(reconstructed)|`` given per-variable L-inf bounds.
Composition implements paper Theorems 7-9 structurally: a parent applies
its base estimator (estimators.py) to each child's ``bound``.

Evaluation is eager torch on the device of the values given (numpy arrays
are taken as CPU tensors); the op order follows the reference, and the
rounding is that of the reference's *compiled* evaluation
(``repro/core/retrieval.py::_estimate`` jits the whole tree).  There XLA
merges identical subtrees, drops ``0 + x`` and ``1 * x``, and LLVM fuses
each multiply whose only use is an add into it (``core/estimators.py``,
ROADMAP C3).  So a node may hand its parent a pending
:class:`~repro_torch.core.estimators.Product` — an IntPow's or Prod's
value, or a Sum's scaled term — and only a Sum or a Radical, whose one use
of it is an add, takes it unrounded.  A subtree used in more than one
place (``temperature()`` in the viscosity) is one node of the compiled
graph with several uses, so its products are rounded.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, FrozenSet, Sequence, Tuple

import torch

from repro_torch.core import estimators as est
from repro_torch.core.estimators import Product, rounded
from repro_torch.device import F64

Tensor = torch.Tensor
ValueBound = Tuple[Tensor, Tensor]


def _device(values: Dict[str, object]) -> torch.device:
    for v in values.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _shared(root: "Expr") -> FrozenSet["Expr"]:
    """Nodes with more than one use once identical subtrees are merged."""
    uses: Counter = Counter()
    seen = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        for ch in node.children_nodes():
            uses[ch] += 1
            stack.append(ch)
    return frozenset(n for n, k in uses.items() if k > 1)


class Expr:
    """Base class of derivable-QoI expression nodes."""

    def eval(self, values: Dict[str, Tensor],
             ebs: Dict[str, Tensor]) -> ValueBound:
        """(value, bound) rounded as the reference's compiled evaluation
        rounds them."""
        v, b = self._eval(values, ebs, _shared(self))
        return rounded(v), rounded(b)

    def _eval(self, values, ebs, shared):
        """(value, bound), either of which may be a pending product."""
        raise NotImplementedError

    def _child(self, ch: "Expr", values, ebs, shared):
        """A child's (value, bound) for a parent whose only use of each is
        an add; rounded when the child has other uses."""
        v, b = ch._eval(values, ebs, shared)
        return (rounded(v), rounded(b)) if ch in shared else (v, b)

    def _rounded(self, ch: "Expr", values, ebs, shared) -> ValueBound:
        v, b = ch._eval(values, ebs, shared)
        return rounded(v), rounded(b)

    def children_nodes(self) -> Tuple["Expr", ...]:
        return ()

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

    def _eval(self, values, ebs, shared):
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

    def _eval(self, values, ebs, shared):
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

    def _eval(self, values, ebs, shared):
        coeffs = self.coeffs if self.coeffs is not None else [1.0] * len(self.children)
        dev = _device(values)
        # XLA folds the zero start and unit coefficients away, and a
        # constant child's term into one constant
        val = None if self.const == 0.0 else torch.tensor(
            self.const, dtype=F64, device=dev)
        bnd = None
        for a, ch in zip(coeffs, self.children):
            cv, cb = self._child(ch, values, ebs, shared)
            if isinstance(ch, Const):
                tv, tb = a * cv, abs(a) * cb
            else:
                tv = cv if a == 1.0 else Product(a, rounded(cv))
                tb = cb if abs(a) == 1.0 else Product(abs(a), rounded(cb))
            val = tv if val is None else est.add(val, tv)
            bnd = tb if bnd is None else est.add(bnd, tb)
        zero = torch.tensor(0.0, dtype=F64, device=dev)
        return (zero if val is None else val), (zero if bnd is None else bnd)

    def children_nodes(self):
        return self.children

    def variables(self):
        out = frozenset()
        for ch in self.children:
            out |= ch.variables()
        return out


@dataclass(frozen=True)
class Prod(Expr):
    """Binary product (Thm 5). Use repeated Prod for Π x_i (Thm 5 + Thm 9).
    ``fuse_right``: which product of the bound's first add the reference's
    compiled graph fuses (``estimators.bound_prod``)."""
    a: Expr
    b: Expr
    fuse_right: bool = True

    def _eval(self, values, ebs, shared):
        av, ab = self._rounded(self.a, values, ebs, shared)
        bv, bb = self._rounded(self.b, values, ebs, shared)
        return Product(av, bv), est.bound_prod(av, ab, bv, bb,
                                               self.fuse_right)

    def children_nodes(self):
        return (self.a, self.b)

    def variables(self):
        return self.a.variables() | self.b.variables()


@dataclass(frozen=True)
class Quot(Expr):
    """Quotient a/b (Thm 6); bound is +inf until ε_b < |b|.
    ``fuse_right`` as in :class:`Prod` (``estimators.bound_quot``)."""
    a: Expr
    b: Expr
    fuse_right: bool = False

    def _eval(self, values, ebs, shared):
        av, ab = self._rounded(self.a, values, ebs, shared)
        bv, bb = self._rounded(self.b, values, ebs, shared)
        safe = torch.where(bv == 0, 1.0, bv)
        val = torch.where(bv == 0, 0.0, av / safe)
        return val, est.bound_quot(av, ab, bv, bb, self.fuse_right)

    def children_nodes(self):
        return (self.a, self.b)

    def variables(self):
        return self.a.variables() | self.b.variables()


@dataclass(frozen=True)
class IntPow(Expr):
    """child^n for integer n >= 1 (Thm 1 composed via Thm 9)."""
    child: Expr
    n: int

    def _eval(self, values, ebs, shared):
        cv, cb = self._rounded(self.child, values, ebs, shared)
        return (est.ipow(cv, self.n, pending=True),
                est.bound_intpow(cv, cb, self.n))

    def children_nodes(self):
        return (self.child,)

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

    def _eval(self, values, ebs, shared):
        cv, cb = self._rounded(self.child, values, ebs, shared)
        cv = torch.clamp_min(cv, 0.0)
        return est.sqrt(cv), est.bound_sqrt(cv, cb, tight=self.tight)

    def children_nodes(self):
        return (self.child,)

    def variables(self):
        return self.child.variables()


@dataclass(frozen=True)
class Radical(Expr):
    """1/(child + c) (Thm 3 composed via Thm 9)."""
    child: Expr
    c: float = 0.0

    def _eval(self, values, ebs, shared):
        # the value's and the bound's ``x + c`` are one add once merged
        cv, cb = self._child(self.child, values, ebs, shared)
        cb = rounded(cb)
        xc = est.add(cv, self.c)
        safe = torch.where(xc == 0, 1.0, xc)
        val = torch.where(xc == 0, 0.0, 1.0 / safe)
        return val, est.bound_radical(cv, cb, self.c)

    def children_nodes(self):
        return (self.child,)

    def variables(self):
        return self.child.variables()


@dataclass(frozen=True)
class Log(Expr):
    """ln(child) — beyond-paper basis (estimators.bound_log)."""
    child: Expr

    def _eval(self, values, ebs, shared):
        cv, cb = self._rounded(self.child, values, ebs, shared)
        safe = torch.clamp_min(cv, 1e-300)
        return torch.log(safe), est.bound_log(cv, cb)

    def children_nodes(self):
        return (self.child,)

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
