"""Cross-session request coalescing (single-flight reconstruction).

Counterpart of ``repro/serve/coalesce.py`` (pure stdlib, copied as it is).

N clients tightening the same variable to the same eps from the same
decode state would each fetch the same plane segments and re-run the same
recompose.  The coalescer collapses them: one *leader* performs the real
``reader.request(eps)``; every concurrent duplicate *waits*, then adopts
the leader's reconstruction after advancing its own (cache-hot) streams.

Correctness leans on the decode invariant the incremental-recompose layer
already asserts (core/refactor.py module docstring): decoded values — and
therefore the reconstruction — are a pure function of the per-group
fetched-plane counts.  The flight key therefore includes the caller's
*state signature* (the tuple of per-stream fetched counts): two sessions
only share a flight when they start from identical decode states, and a
waiter only adopts when its post-advance signature equals the leader's
end signature.  Any mismatch (a concurrent request at a different eps
moved the waiter's streams in between, a degraded stream pinned early)
falls back to a plain ``request`` — strictly correct, merely uncoalesced.

The waiter's ``advance_to`` moves its own streams through the shared
SegmentCache — the leader's fetch already inserted every segment, so the
advance is byte-cheap and performs NO recompose; ``adopt_reconstruction``
then installs the shared field.  Results are bit-identical to a
sequential single-client run at the same tolerances (asserted in
tests/test_torch_serve.py).

Interplay with decode batching (repro_torch.serve.batch): the coalescer
merges *identical* requests into one flight; the DecodeBatcher merges the
device work of *distinct* flights.  Leaders of different (variable, eps)
flights running on different worker threads flush their decodes within the
same batching window, so one batched launch covers every flight of a
serve tick — the two layers compose without knowing about each other
(flights interact only through pure decode dispatches, never through
shared mutable state).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class CoalesceStats:
    """Counters for one ReconstructCoalescer (mutated under its lock)."""
    leaders: int = 0          # flights executed for real
    hits: int = 0             # duplicate requests that joined a flight
    adoptions: int = 0        # waiters that adopted the leader's result
    fallbacks: int = 0        # waiters that re-requested (sig mismatch/error)
    uncoalescable: int = 0    # readers without signature/adopt support

    def snapshot(self) -> Dict[str, float]:
        return {
            "leaders_total": float(self.leaders),
            "hits_total": float(self.hits),
            "adoptions_total": float(self.adoptions),
            "fallbacks_total": float(self.fallbacks),
            "uncoalescable_total": float(self.uncoalescable),
        }


class _Flight:
    """One in-progress leader request; waiters block on ``done``."""

    __slots__ = ("done", "result", "error")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.result: Optional[Tuple] = None   # (recon, end_signature)
        self.error: Optional[BaseException] = None

    def set(self, result: Tuple) -> None:
        self.result = result
        self.done.set()

    def set_error(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()


class ReconstructCoalescer:
    """Single-flight map over (variable, eps, decode-state) keys.

    One coalescer serves ONE archive (the serve plane builds one per
    ``RetrievalServer``); sessions opt in via ``session.coalescer``.
    ``wait_timeout_s`` bounds how long a waiter blocks on a stuck leader
    before falling back to its own request (fail-open, never fail-stuck).
    """

    def __init__(self, wait_timeout_s: float = 120.0):
        self.wait_timeout_s = float(wait_timeout_s)
        self._mu = threading.Lock()
        self._inflight: Dict[Tuple, _Flight] = {}
        self.stats = CoalesceStats()

    def reconstruct(self, session, name: str, eps: float):
        """Drop-in for ``session.readers[name].request(eps)`` with
        cross-session sharing; returns ``(data, achieved_bound)``."""
        reader = session.readers[name]
        sig_fn = getattr(reader, "state_signature", None)
        if sig_fn is None or not hasattr(reader, "adopt_reconstruction"):
            with self._mu:
                self.stats.uncoalescable += 1
            return reader.request(eps)
        key = (name, float(eps), sig_fn())
        with self._mu:
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight()
                self._inflight[key] = flight
                self.stats.leaders += 1
                is_leader = True
            else:
                self.stats.hits += 1
                is_leader = False
        if is_leader:
            try:
                data, achieved = reader.request(eps)
                flight.set((data, sig_fn()))
            except BaseException as exc:
                flight.set_error(exc)
                raise
            finally:
                with self._mu:
                    self._inflight.pop(key, None)
            return data, achieved
        return self._join(flight, reader, eps)

    def _join(self, flight: _Flight, reader, eps: float):
        if not flight.done.wait(self.wait_timeout_s) or \
                flight.error is not None:
            with self._mu:
                self.stats.fallbacks += 1
            return reader.request(eps)
        data, end_sig = flight.result
        # advance this session's own streams (cache-hot: the leader's fetch
        # already populated the SegmentCache) WITHOUT recomposing, then
        # adopt the shared field if the decode states really converged
        reader.advance_to(eps)
        if reader.state_signature() == end_sig:
            reader.adopt_reconstruction(data)
            with self._mu:
                self.stats.adoptions += 1
            return data, reader.achieved_bound()
        with self._mu:
            self.stats.fallbacks += 1
        return reader.request(eps)

    def metrics(self) -> Dict[str, float]:
        with self._mu:
            out = self.stats.snapshot()
            out["inflight"] = float(len(self._inflight))
        return out
