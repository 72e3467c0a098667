"""Serve-plane observability: counters + latency quantiles, plaintext dump.

Counterpart of ``repro/serve/metrics.py`` (pure stdlib, copied as it is).

The /metrics endpoint is a plaintext ``name value`` dump (one counter per
line, sorted) — the lowest-common-denominator format every scraper can
ingest and every human can ``curl``.  Latency quantiles come from a
log-bucketed histogram rather than a reservoir: fixed memory, lock-cheap
increments, and the p50/p99 estimates stay within one bucket width (~7%)
of the true quantile, which is plenty for tail-amplification reporting.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Tuple

# Buckets span 10us .. ~167s at x1.25 steps: 1.25^72 ~= 9.3e6, i.e. enough
# resolution for sub-ms cache hits and patience for WAN-bound tail requests.
_BUCKET_BASE_S = 10e-6
_BUCKET_GROWTH = 1.25
_N_BUCKETS = 72


class LatencyHistogram:
    """Fixed-size log-bucketed latency histogram with quantile estimates.

    ``observe`` is O(1) under one lock; ``quantile`` walks the buckets and
    returns the upper edge of the bucket containing the requested rank —
    a <= one-bucket-width overestimate, monotone in q.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts = [0] * (_N_BUCKETS + 1)   # last bucket = overflow
        self._n = 0
        self._sum_s = 0.0
        self._max_s = 0.0

    @staticmethod
    def _bucket(seconds: float) -> int:
        if seconds <= _BUCKET_BASE_S:
            return 0
        b = int(math.log(seconds / _BUCKET_BASE_S) / math.log(_BUCKET_GROWTH))
        return min(b + 1, _N_BUCKETS)

    @staticmethod
    def _edge(bucket: int) -> float:
        return _BUCKET_BASE_S * (_BUCKET_GROWTH ** bucket)

    def observe(self, seconds: float) -> None:
        b = self._bucket(max(0.0, float(seconds)))
        with self._mu:
            self._counts[b] += 1
            self._n += 1
            self._sum_s += seconds
            if seconds > self._max_s:
                self._max_s = seconds

    @property
    def count(self) -> int:
        with self._mu:
            return self._n

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in seconds (0.0 when empty)."""
        q = min(1.0, max(0.0, q))
        with self._mu:
            if self._n == 0:
                return 0.0
            rank = q * self._n      # nearest-rank: p99 of 10 = the max
            seen = 0
            for b, c in enumerate(self._counts):
                seen += c
                if seen > rank:
                    return min(self._edge(b), self._max_s)
            return self._max_s

    def snapshot(self) -> Dict[str, float]:
        with self._mu:
            n, total, mx = self._n, self._sum_s, self._max_s
        return {
            "count": float(n),
            "mean_ms": (total / n * 1e3) if n else 0.0,
            "p50_ms": self.quantile(0.50) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "max_ms": mx * 1e3,
        }


class MetricsRegistry:
    """Aggregates counter *sources* into one flat ``/metrics`` view.

    A source is a zero-arg callable returning ``{name: number}``; the serve
    plane registers one per subsystem (pool, coalescer, budget pool, cache,
    fetcher, httpd) so the endpoint needs no knowledge of any of them.
    Collisions are a programming error and raise at render time — silent
    last-writer-wins would corrupt dashboards invisibly.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._sources: List[Tuple[str, Callable[[], Dict[str, float]]]] = []

    def register(self, prefix: str,
                 source: Callable[[], Dict[str, float]]) -> None:
        with self._mu:
            self._sources.append((prefix, source))

    def collect(self) -> Dict[str, float]:
        with self._mu:
            sources = list(self._sources)
        out: Dict[str, float] = {}
        for prefix, source in sources:
            for name, value in source().items():
                key = f"{prefix}_{name}" if prefix else name
                if key in out:
                    raise ValueError(f"duplicate metric {key!r}")
                out[key] = float(value)
        return out

    def render(self) -> str:
        """Plaintext dump: one ``name value`` per line, sorted by name."""
        return render_metrics(self.collect())


def render_metrics(values: Dict[str, float]) -> str:
    """Render a flat counter dict as the plaintext /metrics body."""
    return "".join(f"{name} {values[name]:g}\n" for name in sorted(values))
