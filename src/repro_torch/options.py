"""Open and session options of the port.

Counterpart of ``repro/options.py``: :class:`OpenOptions` (how a store
archive is opened: transport, verification, caching, fault tolerance) and
:class:`SessionOptions` (how one retrieval session reads), reduced to the
fields the readers, the store plane, live archives and the serve plane
read.  The reference's shim for pre-v4 loose keyword arguments has no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass(frozen=True)
class OpenOptions:
    """How an archive container is opened (transport + integrity layer).

      * ``prefetch_workers`` — background segment-fetch threads (0 disables
        async prefetch); they move bytes only, never touch the device;
      * ``verify`` — crc32c-check every delivered segment;
      * ``blob_resolver`` — override blob-name -> ByteStore lookup so shards
        can mix backends;
      * ``cache`` — cross-session ``SegmentCache``;
      * ``archive_id`` — cache budget-group override (default: manifest
        hash);
      * ``retry_policy`` / ``quarantine`` — fault-tolerance layer
        (``repro_torch.store.retry``); None enables the hardened defaults;
      * ``follow`` — replay the manifest v4 journal on open and allow
        ``StoreArchive.refresh()`` to tail it afterwards (live archives);
        False pins the session to the base manifest.
    """
    prefetch_workers: int = 2
    verify: bool = True
    blob_resolver: Optional[Callable[[str], Any]] = None
    cache: Optional[Any] = None
    archive_id: Optional[str] = None
    retry_policy: Optional[Any] = None
    quarantine: Optional[Any] = None
    follow: bool = True

    @classmethod
    def default(cls) -> "OpenOptions":
        """Single-client defaults: verified reads, light prefetch."""
        return cls()

    @classmethod
    def multi_tenant(cls, cache, retry_policy=None,
                     quarantine=None) -> "OpenOptions":
        """Serve-plane preset: a shared cross-session cache plus the
        hardened retry/quarantine defaults (None keeps them enabled)."""
        return cls(cache=cache, retry_policy=retry_policy,
                   quarantine=quarantine)


@dataclass(frozen=True)
class SessionOptions:
    """How one retrieval session reads.

      * ``prefetch_depth`` — how many ``reassign_eb`` reduction steps ahead
        the retrieval loop may hint to the fetcher;
      * ``contrib_budget_bytes`` — per-variable cap on each bitplane
        reader's retained contribution cache (None = unbounded; outputs are
        bit-identical at any budget);
      * ``contrib_pool`` — server-wide
        :class:`repro_torch.serve.budget.ContribBudgetPool` replacing the
        static cap (takes precedence when both are set);
      * ``decode_batcher`` — shared
        :class:`repro_torch.serve.batch.DecodeBatcher` merging this
        session's decode / recompose work with every other session's into
        one launch per shape bucket and serve tick (None = per-reader
        launches; results are bit-identical either way).
    """
    prefetch_depth: int = 1
    contrib_budget_bytes: Optional[int] = None
    contrib_pool: Optional[Any] = None
    decode_batcher: Optional[Any] = None

    @classmethod
    def memory_bounded(cls, budget_bytes: int) -> "SessionOptions":
        """Cap each variable's resident recompose state; spilled levels are
        rebuilt on demand (outputs stay bit-identical)."""
        return cls(contrib_budget_bytes=int(budget_bytes))

    @classmethod
    def pooled(cls, pool) -> "SessionOptions":
        """Serve-plane preset: retention borrows from one shared pool."""
        return cls(contrib_pool=pool)
