"""Algorithms 2-4: QoI-preserved progressive data retrieval, on tensors.

Counterpart of ``repro/core/retrieval.py``.  The loop refines the
reconstruction until the *estimated* QoI error bounds (Section IV theory —
no ground truth needed) drop below the requested tolerances:

  1. assign_eb (Alg 3): initial per-variable bounds from the relative QoI
     tolerances and the variables' value ranges.
  2. reconstruct every involved variable to its current bound (only new
     segments move).
  3. estimate each QoI's error bound on the reconstruction; done when all
     max bounds <= τ_abs.
  4. reassign_eb (Alg 4): at the worst point of the worst QoI, tighten the
     involved variables' bounds by c=1.5 until the point estimate clears
     the tolerance (one batched evaluation of the whole 200-step ladder),
     then loop.

Reconstructions, per-point bounds and QoI fields stay on the session's
device; only scalars (max, min, argmax and the point values at it) and the
ladder's 200 verdicts cross to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.qoi import Expr
from repro_torch.core.refactor import VarAvailability
from repro_torch.device import F64

REDUCTION_FACTOR = 1.5          # c in Alg 4
MIN_REL_EPS = 2.0 ** -60        # full-fidelity floor
LADDER_STEPS = 200              # max Alg-4 tightening steps per iteration


@dataclass
class QoIRequest:
    name: str
    expr: Expr
    tau_rel: float


@dataclass
class IterationLog:
    iteration: int
    eps: Dict[str, float]
    est_errors: Dict[str, float]
    tau_abs: Dict[str, float]
    bytes_retrieved: int


@dataclass
class RetrievalResult:
    values: Dict[str, torch.Tensor]
    achieved_eb: Dict[str, float]
    est_errors: Dict[str, float]
    tau_abs: Dict[str, float]
    bytes_retrieved: int
    bitrate: float
    iterations: List[IterationLog]
    converged: bool
    # certified degraded mode: True when any variable was availability-
    # pinned (permanently missing segments).  ``est_errors`` remain valid
    # upper bounds — computed from what actually decoded — they just may
    # exceed ``tau_abs``; ``availability`` reports the pinned variables.
    degraded: bool = False
    availability: Dict[str, VarAvailability] = field(default_factory=dict)


def assign_eb(requests: Sequence[QoIRequest],
              ranges: Dict[str, float]) -> Dict[str, float]:
    """Algorithm 3: per-variable initial bound = min relative tolerance among
    the QoIs involving the variable, times the variable's range."""
    eps: Dict[str, float] = {}
    for req in requests:
        for v in req.expr.variables():
            rel = min(1.0, req.tau_rel)
            eps[v] = min(eps.get(v, 1.0), rel)
    return {v: e * ranges[v] for v, e in eps.items()}


def _estimate(expr: Expr, values: Dict[str, torch.Tensor],
              ebs: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, bound) of ``expr``: an eager evaluation of the tree on the
    values' device."""
    return expr.eval(values, ebs)


def retrieve_qoi_controlled(session,
                            requests: Sequence[QoIRequest],
                            max_iters: int = 100,
                            reduction: float = REDUCTION_FACTOR,
                            verbose: bool = False) -> RetrievalResult:
    """Algorithm 2 main loop over a RetrievalSession."""
    ranges = session.archive.ranges
    dev = session.device
    needed = sorted(set().union(*[r.expr.variables() for r in requests]))
    for v in needed:
        if v not in session.readers:
            raise KeyError(f"QoI references unknown variable {v!r}")
    eps = assign_eb(requests, ranges)
    floors = {v: MIN_REL_EPS * ranges[v] for v in needed}
    # hints already forwarded, keyed by their eps: only re-hint a variable
    # whose bound changed
    hinted: Dict[str, float] = {}

    def hint(v: str, e: float) -> None:
        if hinted.get(v) != e:
            session.prefetch(v, e)
            hinted[v] = e
    logs: List[IterationLog] = []
    values: Dict[str, torch.Tensor] = {}
    eb_arrays: Dict[str, torch.Tensor] = {}
    achieved: Dict[str, float] = {}
    pinned_vars: set = set()       # availability-pinned (degraded) variables
    converged = False

    for it in range(max_iters):
        # -- progressive reconstruction at current bounds (lines 9-11)
        for v in needed:
            hint(v, eps[v])
        for v in needed:
            data, ach = session.reconstruct(v, eps[v])
            values[v] = data
            achieved[v] = ach
            eb_arrays[v] = session.eb_array(v, ach)

        # -- availability-pinned variables (certified degraded mode): a
        # variable whose segments are permanently unavailable cannot be
        # tightened past its achievable floor — raise its ladder floor so
        # reassign_eb freezes it there instead of re-requesting the same
        # missing planes forever (the frozen/at_floor machinery below then
        # guarantees termination exactly as for codec floors)
        for v, a in session.availability().items():
            if v in floors and np.isfinite(a.floor):
                floors[v] = max(floors[v], a.floor)
                pinned_vars.add(v)

        # -- QoI error estimation (lines 12-24)
        est_errors: Dict[str, float] = {}
        tau_abs: Dict[str, float] = {}
        worst: Optional[Tuple[str, int, float]] = None  # (qoi, flat idx, excess)
        for req in requests:
            val, bound = _estimate(req.expr, values, eb_arrays)
            vmax, vmin, max_err = torch.stack(
                [val.max(), val.min(), bound.max()]).tolist()
            rng = vmax - vmin
            t_abs = req.tau_rel * (rng if rng > 0 else 1.0)
            est_errors[req.name] = max_err
            tau_abs[req.name] = t_abs
            if max_err > t_abs:
                idx = int(torch.argmax(bound))    # first maximum
                excess = max_err / t_abs if np.isfinite(max_err) else np.inf
                if worst is None or excess > worst[2]:
                    worst = (req.name, idx, excess)

        logs.append(IterationLog(iteration=it, eps=dict(eps),
                                 est_errors=dict(est_errors),
                                 tau_abs=dict(tau_abs),
                                 bytes_retrieved=session.bytes_retrieved))
        if verbose:
            print(f"[retrieve] iter={it} bytes={session.bytes_retrieved} "
                  f"est={ {k: f'{v:.3e}' for k, v in est_errors.items()} }")

        if worst is None:
            converged = True
            break

        # -- reassign_eb (Alg 4): tighten on the worst point
        qname, idx, _ = worst
        req = next(r for r in requests if r.name == qname)
        involved = sorted(req.expr.variables())
        at_idx = torch.stack(
            [values[v].reshape(-1)[idx] for v in involved]
            + [eb_arrays[v].reshape(-1)[idx] for v in involved]).tolist()
        pt_vals = dict(zip(involved, at_idx[:len(involved)]))
        pt_eb = dict(zip(involved, at_idx[len(involved):]))
        # exact (masked) points keep their zero bound; a pinned variable's
        # bound cannot drop below what it achieved — seeding its ladder with
        # the (unreachable) requested eps would predict tightenings the
        # reconstruct pass can never deliver
        pt_ebs = {v: pt_eb[v] if pt_eb[v] == 0.0
                  else achieved[v] if v in pinned_vars
                  else min(achieved[v], eps[v]) for v in involved}
        # the whole geometric eps-ladder of candidate bound states in ONE
        # batched evaluation: state t is exactly what t sequential
        # reduction rounds produce (cumulative division, per-variable floor
        # clamp, frozen once at or below the floor)
        ladders: Dict[str, np.ndarray] = {}
        for v in involved:
            lad = np.empty(LADDER_STEPS + 1, dtype=np.float64)
            cur = pt_ebs[v]
            lad[0] = cur
            for t in range(1, LADDER_STEPS + 1):
                if cur > floors[v]:
                    cur = max(cur / reduction, floors[v])
                lad[t] = cur
            ladders[v] = lad
        # -- async segment prefetch: reassign always lands at ladder state
        # t_star >= 1 (state 0 is the current, still-violating bound), so
        # the planes for ladder[depth = 1] are a guaranteed prefix of the
        # next round's fetch.  Hint these predicted eps now, so store-backed
        # sessions move segments in the background while the ladder
        # estimate below and the next estimator round run; depths > 1 hide
        # more latency but may speculate past t_star.
        depth = int(np.clip(getattr(session, "prefetch_depth", 1),
                            1, LADDER_STEPS))
        for v in involved:
            predicted = float(ladders[v][depth])
            if predicted > 0.0:
                session.prefetch(v, min(eps[v], predicted), certain=False)
        _, pb = _estimate(
            req.expr,
            {v: torch.full((LADDER_STEPS,), pt_vals[v], dtype=F64,
                           device=dev) for v in involved},
            {v: torch.from_numpy(ladders[v][:LADDER_STEPS]).to(dev)
             for v in involved})
        ok = (pb <= tau_abs[qname]).cpu().numpy()
        progressable = np.zeros(LADDER_STEPS, dtype=bool)
        for v in involved:
            progressable |= ladders[v][:LADDER_STEPS] > floors[v]
        frozen = ~progressable
        at_floor = False
        if ok.any():
            t_star = int(np.argmax(ok))       # first state meeting tau
        elif frozen.any():
            t_star = int(np.argmax(frozen))   # sequential loop stops here
            at_floor = True
        else:
            t_star = LADDER_STEPS             # exhausted without converging
        pt_ebs = {v: float(ladders[v][t_star]) for v in involved}
        for v in involved:
            eps[v] = min(eps[v], pt_ebs[v]) if pt_ebs[v] > 0 else eps[v]
        for v in involved:
            hint(v, eps[v])
        if at_floor:
            # full fidelity reached and still unbounded -> retrieve all, stop
            for v in involved:
                eps[v] = floors[v]
            for v in needed:
                data, ach = session.reconstruct(v, eps[v])
                values[v], achieved[v] = data, ach
                eb_arrays[v] = session.eb_array(v, ach)
            break

    availability = session.availability()
    return RetrievalResult(values=values, achieved_eb=achieved,
                           est_errors=est_errors, tau_abs=tau_abs,
                           bytes_retrieved=session.bytes_retrieved,
                           bitrate=session.bitrate(needed),
                           iterations=logs, converged=converged,
                           degraded=bool(availability),
                           availability=availability)
