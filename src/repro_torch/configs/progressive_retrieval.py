"""The paper's own "architecture": the progressive-retrieval pipeline
configuration, what the paper itself deploys.

Counterpart of ``repro/configs/progressive_retrieval.py`` (pure Python,
copied as it is).

Defaults follow §V/§VI: PMGARD-HB refactoring, 48 magnitude bitplanes,
c=1.5 tightening, zero-velocity outlier masks, and the PSZ3 ladders
ε_i = range · 10^-i used for the comparison baselines.

Beyond-paper serving knobs (memory-bounded retrieval, see
docs/architecture.md): ``contrib_budget_bytes`` caps each bitplane
reader's retained per-level contribution fields (None = unbounded —
the paper's assumption that full-precision state fits in RAM);
``segment_cache_bytes`` / ``cache_depth_weight`` / ``archive_floor_bytes``
shape the cross-session segment cache's depth-weighted eviction and
per-archive isolation (repro_torch.store.cache).

Concurrent-serve knobs (docs/serving.md): ``serve_workers`` /
``serve_queue_depth`` size the worker pool and its load-shedding
high-water mark; ``contrib_pool_bytes`` replaces the per-variable
contribution budget with one server-wide borrow/return pool;
``cache_admission`` enables the segment cache's churn-avoiding
admission check under multi-tenant pressure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PipelineConfig:
    method: str = "hb"                  # hb | ob | psz3 | psz3_delta
    nbits: int = 48                     # magnitude bitplanes
    reduction_factor: float = 1.5       # Alg 4's c
    mask_zero_velocity: bool = True     # §V-A outlier bitmap
    n_snapshots: int = 10               # PSZ3(-delta) ladder depth
    snapshot_base: float = 10.0         # ε_i = range · base^-i
    max_iters: int = 100
    tight_estimators: bool = False      # beyond-paper exact-sup √ bound
    # memory-bounded retrieval (beyond paper):
    contrib_budget_bytes: Optional[int] = None  # per-variable reader budget
    segment_cache_bytes: int = 256 << 20        # cross-session cache total
    cache_depth_weight: float = 64.0            # MSB-over-LSB eviction bias
    archive_floor_bytes: int = 0                # per-archive residency floor
    # concurrent multi-tenant serving (beyond paper, docs/serving.md):
    serve_workers: int = 8                      # worker-pool threads
    serve_queue_depth: int = 64                 # shed past this many pending
    contrib_pool_bytes: Optional[int] = None    # server-wide pooled budget
    cache_admission: bool = False               # churn-avoiding insert gate

    def server_kwargs(self) -> dict:
        """The memory + serving knobs as `repro_torch.launch.serve.RetrievalServer`
        kwargs — `RetrievalServer(fields, **cfg.server_kwargs())`.  Kept in
        one place so the config fields and the server signature cannot drift
        apart (asserted in tests/test_torch_serve.py)."""
        return {"method": self.method,
                "cache_bytes": self.segment_cache_bytes,
                "cache_depth_weight": self.cache_depth_weight,
                "archive_floor_bytes": self.archive_floor_bytes,
                "contrib_budget_bytes": self.contrib_budget_bytes,
                "workers": self.serve_workers,
                "queue_depth": self.serve_queue_depth,
                "contrib_pool_bytes": self.contrib_pool_bytes,
                "cache_admission": self.cache_admission}


def config() -> PipelineConfig:
    return PipelineConfig()


def reduced_config() -> PipelineConfig:
    return PipelineConfig(nbits=32, n_snapshots=4, max_iters=20)


def memory_bounded_config(contrib_budget_bytes: int = 32 << 20,
                          segment_cache_bytes: int = 64 << 20,
                          archive_floor_bytes: int = 8 << 20
                          ) -> PipelineConfig:
    """A serving profile for many concurrent sessions/variables per host:
    coarse contribution fields spill (bit-identical recompute on touch) and
    the segment cache keeps shared MSB prefixes while isolating archives."""
    return PipelineConfig(contrib_budget_bytes=contrib_budget_bytes,
                          segment_cache_bytes=segment_cache_bytes,
                          archive_floor_bytes=archive_floor_bytes)


def multi_tenant_config(contrib_pool_bytes: int = 64 << 20,
                        segment_cache_bytes: int = 128 << 20,
                        workers: int = 8,
                        queue_depth: int = 64) -> PipelineConfig:
    """A concurrent-serving profile (docs/serving.md): worker pool with
    load shedding, one pooled contribution budget shared by every session
    (hottest variables stay resident), and cache admission control so one
    deep-descending tenant cannot churn the shared MSB prefix."""
    return PipelineConfig(contrib_pool_bytes=contrib_pool_bytes,
                          segment_cache_bytes=segment_cache_bytes,
                          serve_workers=workers,
                          serve_queue_depth=queue_depth,
                          cache_admission=True)
