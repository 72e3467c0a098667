"""Concurrent multi-tenant serve plane.

Counterpart of ``repro/serve``.  The paper's deployment shape (Fig. 1) is
many analysis clients pulling on-demand-precision reconstructions from ONE
progressive archive; this package makes ``repro_torch.launch.serve`` a
service on the card:

  * :mod:`repro_torch.serve.pool`     — bounded worker pool with
    per-session locking, load shedding (503 + Retry-After past the
    high-water mark) and handle-latency histograms.
  * :mod:`repro_torch.serve.coalesce` — cross-session request coalescing:
    N clients tightening the same variable to the same eps from the same
    decode state share one fetch + one recompose; the result is fanned out
    to every waiter (bit-identical by the plane-count invariant).
  * :mod:`repro_torch.serve.batch`    — cross-session decode batching: one
    launch of the batched decode kernel per shape bucket and serve tick,
    covering every reader's newly fetched planes of one word width, with
    the solo kernel for stragglers whose shape matches nobody.
  * :mod:`repro_torch.serve.budget`   — server-level pooled contribution
    budget replacing the per-variable ``contrib_budget_bytes``: readers
    borrow/return field-sized leases against one pool so the hottest
    variables win.
  * :mod:`repro_torch.serve.metrics`  — plaintext counter dump +
    log-bucketed latency histogram backing the ``/health`` and
    ``/metrics`` endpoints on :mod:`repro_torch.store.httpd`.
"""
from repro_torch.serve.batch import BatcherStats, DecodeBatcher
from repro_torch.serve.budget import ContribBudgetPool, PoolStats
from repro_torch.serve.coalesce import CoalesceStats, ReconstructCoalescer
from repro_torch.serve.metrics import (LatencyHistogram, MetricsRegistry,
                                       render_metrics)
from repro_torch.serve.pool import ServePlane, ServerOverloadedError

__all__ = [
    "BatcherStats",
    "DecodeBatcher",
    "ContribBudgetPool",
    "PoolStats",
    "CoalesceStats",
    "ReconstructCoalescer",
    "LatencyHistogram",
    "MetricsRegistry",
    "render_metrics",
    "ServePlane",
    "ServerOverloadedError",
]
