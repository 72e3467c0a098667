"""Open and session options of the port.

Counterpart of ``repro/options.py``: two frozen dataclasses,
:class:`OpenOptions` (how a store archive is opened: transport,
verification, caching, fault tolerance) and :class:`SessionOptions` (how
one retrieval session reads: prefetch depth, contribution budget or pool,
decode batcher), with presets for the common deployments.

The pre-v4 loose keyword arguments (``open_archive(path, verify=False)``,
``archive.open(contrib_budget_bytes=...)``) keep working through a shim
that warns ONCE per call-site pattern with :class:`ReproDeprecationWarning`.
The port's ``device`` argument is a real keyword everywhere and never goes
through the shim.

This module imports nothing from ``repro_torch.store`` or
``repro_torch.core``: both shim layers import it, so it sits below them.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace
from typing import Any, Callable, Optional

__all__ = [
    "OpenOptions",
    "SessionOptions",
    "ReproDeprecationWarning",
    "warn_deprecated_once",
]


class ReproDeprecationWarning(DeprecationWarning):
    """A deprecated API spelling of the port (legacy kwargs, shimmed
    signatures).  Its own type, so a caller can escalate exactly these to
    errors without third-party deprecation noise."""


_warned: set = set()


def warn_deprecated_once(key: str, message: str, stacklevel: int = 3) -> None:
    """Emit ``message`` as a ReproDeprecationWarning the FIRST time ``key``
    is seen in this process; later identical call sites stay silent, so a
    serve loop calling a shimmed API per request does not flood stderr."""
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(message, ReproDeprecationWarning, stacklevel=stacklevel)


def _reset_deprecation_warnings() -> None:
    """Test hook: make every deprecation warn again."""
    _warned.clear()


def _from_legacy(cls, legacy: dict, where: str):
    """Build an options object from legacy kwargs, warning once.  Unknown
    names raise TypeError, as a real signature mismatch would."""
    valid = {f.name for f in fields(cls)}
    unknown = set(legacy) - valid
    if unknown:
        raise TypeError(f"{where}: unexpected keyword argument(s) "
                        f"{sorted(unknown)}")
    warn_deprecated_once(
        f"{where}:{','.join(sorted(legacy))}",
        f"{where}: passing {sorted(legacy)} as loose keyword arguments is "
        f"deprecated; pass {cls.__name__}(...) instead",
    )
    return cls(**legacy)


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

    @classmethod
    def unverified(cls) -> "OpenOptions":
        """Forensics preset: skip crc32c so a damaged container can still
        be inspected; never publishes bytes to a shared cache."""
        return cls(verify=False)

    def with_(self, **changes) -> "OpenOptions":
        return replace(self, **changes)


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
    def default(cls) -> "SessionOptions":
        return cls()

    @classmethod
    def memory_bounded(cls, budget_bytes: int) -> "SessionOptions":
        """Cap each variable's resident recompose state; spilled levels are
        rebuilt on demand (outputs stay bit-identical)."""
        return cls(contrib_budget_bytes=int(budget_bytes))

    @classmethod
    def pooled(cls, pool) -> "SessionOptions":
        """Serve-plane preset: retention borrows from one shared pool."""
        return cls(contrib_pool=pool)

    def with_(self, **changes) -> "SessionOptions":
        return replace(self, **changes)
