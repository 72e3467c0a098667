# Copy of repro/store/retry.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""Unified fault-tolerance policy for the retrieval plane.

Two small, reusable pieces shared by every ByteStore backend and by the
SegmentFetcher (which wraps *all* backends, so even stores with no internal
retry — memory, mmap, the WAN model — get one consistent policy):

  * ``RetryPolicy`` — max attempts, exponential backoff with FULL jitter
    (sleep = uniform(0, min(cap, base·2^(attempt-1))); unjittered backoff
    synchronizes clients into retry storms against a shared store), a
    backoff cap, and a per-fetch wall-clock deadline.  The deadline is the
    arbiter of "transient vs permanent": a fault schedule that heals inside
    the deadline is absorbed invisibly; one that does not becomes a
    certified *degraded-mode* result upstream (see core/refactor.py).

  * ``BlobQuarantine`` — a per-blob circuit breaker.  K *consecutive*
    failures open the circuit for that blob: further reads fast-fail with
    ``BlobQuarantinedError`` instead of burning a full retry budget per
    segment against a store that is known-dead.  After a cooldown the
    circuit goes half-open: exactly one probe read is let through (other
    readers keep fast-failing); success closes the circuit, failure
    re-opens it with a doubled (capped) cooldown.

``is_transient`` is the shared error classifier: transport-shaped failures
(timeouts, resets, 5xx-wrapping IOErrors, checksum mismatches — a bit flip
in transit heals on re-read) retry; caller bugs (negative lengths, reads
past EOF) and definitively-missing resources (``FileNotFoundError``) fail
immediately — retrying a file that does not exist only delays the
quarantine that protects the rest of the session.
"""
from __future__ import annotations

import http.client
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


class SegmentUnavailableError(IOError):
    """A segment could not be delivered within the retry policy's budget."""


class BlobQuarantinedError(SegmentUnavailableError):
    """Fast-fail: the segment's blob is quarantined (circuit open) and the
    caller's budget cannot cover waiting for the next half-open probe."""


_PERMANENT = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
              PermissionError)


def is_transient(exc: BaseException) -> bool:
    """True when retrying the operation could plausibly succeed."""
    if isinstance(exc, _PERMANENT):
        return False
    if isinstance(exc, (EOFError, ValueError, KeyError, TypeError)):
        return False                       # caller bugs, not store weather
    return isinstance(exc, (OSError, socket.timeout, TimeoutError,
                            ConnectionError, http.client.HTTPException))


@dataclass(frozen=True)
class RetryPolicy:
    """Shared retry/backoff/deadline policy for segment transport.

    ``max_attempts`` counts the first try (``max_attempts=1`` == never
    retry).  ``backoff_s`` is the base of the exponential schedule;
    ``backoff_cap_s`` caps any single sleep; ``jitter`` draws the actual
    sleep uniformly from [0, capped backoff] (AWS "full jitter").
    ``deadline_s`` bounds one *fetch* (all attempts + sleeps) in wall-clock
    seconds; ``None`` leaves only the attempt count as the limit."""
    max_attempts: int = 4
    backoff_s: float = 0.05
    backoff_cap_s: float = 1.0
    deadline_s: Optional[float] = 30.0
    jitter: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.backoff_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff must be non-negative")

    @classmethod
    def none(cls) -> "RetryPolicy":
        """No retries: one attempt, no deadline — the legacy behaviour of
        every non-HTTP backend."""
        return cls(max_attempts=1, backoff_s=0.0, deadline_s=None)

    @property
    def retries_enabled(self) -> bool:
        return self.max_attempts > 1

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Sleep before retry number ``attempt`` (1-based): capped
        exponential, fully jittered."""
        cap = min(self.backoff_cap_s,
                  self.backoff_s * (2.0 ** max(0, attempt - 1)))
        if not self.jitter:
            return cap
        return (rng.uniform if rng is not None else random.uniform)(0.0, cap)

    def deadline_from(self, t0: float) -> float:
        """Absolute monotonic deadline for a fetch that started at ``t0``."""
        return float("inf") if self.deadline_s is None \
            else t0 + self.deadline_s


# circuit states returned by BlobQuarantine.check()
CLOSED = "closed"      # healthy: read normally
OPEN = "open"          # quarantined: wait ``wait_s`` for the next probe slot
PROBE = "probe"        # half-open: caller holds the single probe token


class BlobQuarantine:
    """Per-blob circuit breaker (thread-safe).

    ``threshold`` consecutive failed read attempts on a blob open its
    circuit for ``cooldown_s``; each failed half-open probe doubles the
    cooldown up to ``cooldown_cap_s``.  Any successful read fully resets
    the blob's state.  ``events`` counts open transitions (exported as
    ``FetchStats.quarantined_blobs``)."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.5,
                 cooldown_cap_s: float = 8.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.events = 0
        self._lock = threading.Lock()
        # blob -> [consecutive_failures, open_until (monotonic) | None,
        #          probing, current_cooldown]
        self._state: Dict[str, list] = {}

    def check(self, blob: str) -> Tuple[str, float]:
        """(state, wait_s): CLOSED -> read; PROBE -> read (this caller owns
        the one half-open probe and MUST report the outcome); OPEN -> the
        circuit stays closed to this caller for another ``wait_s``
        seconds."""
        now = time.monotonic()
        with self._lock:
            st = self._state.get(blob)
            if st is None or st[1] is None:
                return CLOSED, 0.0
            if st[2]:                        # someone else holds the probe
                return OPEN, st[3]
            if now >= st[1]:
                st[2] = True
                return PROBE, 0.0
            return OPEN, st[1] - now

    def record_failure(self, blob: str) -> bool:
        """Note one failed read attempt; returns True when this failure
        *opens* the circuit (a quarantine event)."""
        now = time.monotonic()
        with self._lock:
            st = self._state.setdefault(
                blob, [0, None, False, self.cooldown_s])
            st[0] += 1
            if st[1] is not None and st[2]:      # failed half-open probe
                st[2] = False
                st[3] = min(self.cooldown_cap_s, st[3] * 2.0)
                st[1] = now + st[3]
                return False
            if st[1] is None and st[0] >= self.threshold:
                st[1] = now + st[3]
                self.events += 1
                return True
            return False

    def record_success(self, blob: str) -> None:
        with self._lock:
            self._state.pop(blob, None)

    def quarantined(self) -> Tuple[str, ...]:
        """Blobs whose circuit is currently open (cooldown may have lapsed
        — they stay listed until a successful probe closes them)."""
        with self._lock:
            return tuple(sorted(b for b, st in self._state.items()
                                if st[1] is not None))

    def is_quarantined(self, blob: str) -> bool:
        with self._lock:
            st = self._state.get(blob)
            return st is not None and st[1] is not None
