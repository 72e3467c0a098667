# Copy of repro/store/faults.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""Deterministic chaos for ByteStores: seeded fault injection on any backend.

``httpd.transient_faults`` can only chaos-test the HTTP path; this wrapper
makes *every* backend chaos-testable by sitting between the fetcher and any
inner ByteStore and injecting faults on a deterministic, seeded schedule:

  * transient errors     IOError raised, later attempts succeed
  * timeouts             socket.timeout (what a stalled link raises)
  * truncated reads      short payloads (fails the fetcher's length check)
  * bit flips            one flipped bit (fails crc32c verification)
  * slow reads           an extra ``slow_s`` sleep, payload intact
  * persistent loss      ranges/blobs that NEVER deliver

Determinism is the point: every decision is a pure hash of ``(seed, offset,
length, k)`` where ``k`` counts the calls made for that exact range, so a
schedule replays identically regardless of thread interleaving across
ranges — a failing chaos test reproduces from its printed seed alone.

"Eventually heals" is a *guarantee*, not a probability: a range injects at
most ``max_faults_per_range`` faults (default 2), so any retry policy with
more attempts than that always converges — the contract the chaos suite's
bit-identical-after-healing assertions lean on.  Set it to ``None`` for
rate-only injection (faults forever, at ``rate``).
"""
from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.store.bytestore import ByteStore


@dataclass(frozen=True)
class FaultPlan:
    """What to inject and how often.  ``rate`` is the per-call probability
    that *some* fault fires; ``weights`` splits it across kinds."""
    rate: float = 0.25
    error_weight: float = 1.0      # plain transient IOError
    timeout_weight: float = 0.0    # socket.timeout
    truncate_weight: float = 0.0   # short read (length check trips)
    flip_weight: float = 0.0      # one bit flipped (crc check trips)
    slow_weight: float = 0.0      # delivered intact, after slow_s
    slow_s: float = 0.01
    # hard healing bound: at most this many faults per distinct range
    # (None = faults keep firing at ``rate`` forever)
    max_faults_per_range: Optional[int] = 2
    # (offset, length-span) windows that NEVER deliver — permanent loss
    dead_ranges: Tuple[Tuple[int, int], ...] = ()

    def _weights(self):
        kinds = (("error", self.error_weight),
                 ("timeout", self.timeout_weight),
                 ("truncate", self.truncate_weight),
                 ("flip", self.flip_weight),
                 ("slow", self.slow_weight))
        total = sum(w for _, w in kinds)
        if total <= 0:
            raise ValueError("FaultPlan needs at least one positive weight")
        return [(k, w / total) for k, w in kinds if w > 0]


@dataclass
class FaultStats:
    injected: Dict[str, int] = field(default_factory=dict)
    reads: int = 0

    @property
    def total(self) -> int:
        return sum(self.injected.values())


class FaultInjectingByteStore(ByteStore):
    """Wrap any ByteStore with a seeded fault schedule (thread-safe).

    Decisions are keyed on ``(seed, offset, length, k)`` — ``k`` is the
    per-range call counter — so schedules are deterministic under any
    thread interleaving.  ``read_batch`` deliberately degrades to per-range
    ``read`` calls: every range gets its own independent fault decision,
    and a batched caller cannot smuggle ranges past the schedule."""

    def __init__(self, inner: ByteStore, plan: FaultPlan = FaultPlan(),
                 seed: int = 0):
        self.inner = inner
        self.plan = plan
        self.seed = int(seed)
        self.stats = FaultStats()
        self._weights = plan._weights() if plan.rate > 0 else []
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[int, int], int] = {}

    # -- deterministic draws -------------------------------------------------

    def _draw(self, offset: int, length: int, k: int, salt: int) -> float:
        h = hashlib.blake2b(
            struct.pack("<qqqqq", self.seed, offset, length, k, salt),
            digest_size=8).digest()
        return struct.unpack("<Q", h)[0] / 2.0 ** 64

    def _decide(self, offset: int, length: int) -> Optional[str]:
        with self._lock:
            k = self._calls.get((offset, length), 0)
            self._calls[(offset, length)] = k + 1
            self.stats.reads += 1
        for start, span in self.plan.dead_ranges:
            if offset < start + span and start < offset + length:
                return "dead"
        if not self._weights:
            return None
        if self.plan.max_faults_per_range is not None \
                and k >= self.plan.max_faults_per_range:
            return None                      # healed: hard per-range cap
        if self._draw(offset, length, k, 0) >= self.plan.rate:
            return None
        u = self._draw(offset, length, k, 1)
        acc = 0.0
        for kind, w in self._weights:
            acc += w
            if u < acc:
                return kind
        return self._weights[-1][0]

    def _note(self, kind: str) -> None:
        with self._lock:
            self.stats.injected[kind] = self.stats.injected.get(kind, 0) + 1

    # -- ByteStore surface ---------------------------------------------------

    def read(self, offset: int, length: int) -> bytes:
        kind = self._decide(offset, length)
        if kind == "dead":
            self._note(kind)
            raise IOError(f"injected permanent loss at "
                          f"[{offset}:+{length}] (seed {self.seed})")
        if kind == "error":
            self._note(kind)
            raise IOError(f"injected transient fault at "
                          f"[{offset}:+{length}] (seed {self.seed})")
        if kind == "timeout":
            self._note(kind)
            raise socket.timeout(f"injected timeout at [{offset}:+{length}] "
                                 f"(seed {self.seed})")
        data = self.inner.read(offset, length)
        if kind == "truncate" and length > 0:
            self._note(kind)
            return data[:max(0, length - 1 - int(
                self._draw(offset, length, 0, 2) * min(length, 16)))]
        if kind == "flip" and length > 0:
            self._note(kind)
            i = int(self._draw(offset, length, 0, 3) * length) % length
            buf = bytearray(data)
            buf[i] ^= 1 << (int(self._draw(offset, length, 0, 4) * 8) % 8)
            return bytes(buf)
        if kind == "slow":
            self._note(kind)
            time.sleep(self.plan.slow_s)
        return data

    def read_batch(self, ranges: Sequence[Tuple[int, int]]):
        # per-range reads on purpose: each range must face the schedule
        return [self.read(off, ln) for off, ln in ranges]

    @property
    def size(self) -> int:
        return self.inner.size

    def close(self) -> None:
        self.inner.close()
