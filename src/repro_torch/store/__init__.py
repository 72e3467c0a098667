"""Segment store & transport for archives of every method: container, byte
stores, prefetching (counterpart of ``repro.store``).

``save_archive`` / ``save_sharded_archive`` serialize a refactored
`Archive` into a manifest + segment payload container — one blob, or one
blob per variable / level group — byte-identical to the JAX package's;
``open_archive`` serves it back through pluggable ByteStore backends (RAM,
mmap'd file, HTTP ranged GETs, simulated WAN link) with per-segment crc32c
verification, a SegmentFetcher whose threads prefetch predicted planes in
the background, and an optional cross-session SegmentCache.  Sessions on an
opened archive decode on its device (default CUDA).  ``ArchiveWriter``
appends timesteps to a live (journaled, v4) archive that open sessions
follow through ``StoreArchive.refresh()``.
``repro_torch.store.httpd`` is the matching ranged-GET endpoint.
"""
from repro_torch.options import OpenOptions, ReproDeprecationWarning, \
    SessionOptions
from repro_torch.store.bytestore import (
    ByteStore,
    FileByteStore,
    HTTPByteStore,
    HTTPStats,
    MemoryByteStore,
    RemoteByteStore,
)
from repro_torch.store.cache import CacheStats, SegmentCache
from repro_torch.store.container import (
    JOURNAL_NAME,
    StoreArchive,
    StoreBitplaneVar,
    StoreSnapshotVar,
    StoreTimeseriesVar,
    build_container,
    build_sharded_container,
    manifest_archive_id,
    memory_store_archive,
    open_archive,
    save_archive,
    save_sharded_archive,
    segment_depth,
)
from repro_torch.store.crc import crc32c
from repro_torch.store.faults import FaultInjectingByteStore, FaultPlan, \
    FaultStats
from repro_torch.store.fetcher import (
    ChecksumError,
    FetchStats,
    SegmentEntry,
    SegmentFetcher,
)
from repro_torch.store.httpd import StoreHTTPServer
from repro_torch.store.retry import (
    BlobQuarantine,
    BlobQuarantinedError,
    RetryPolicy,
    SegmentUnavailableError,
    is_transient,
)
from repro_torch.store.writer import ArchiveWriter, ensure_archive

__all__ = [
    "ByteStore", "MemoryByteStore", "FileByteStore", "HTTPByteStore",
    "HTTPStats", "RemoteByteStore",
    "SegmentCache", "CacheStats",
    "StoreArchive", "StoreBitplaneVar", "StoreSnapshotVar",
    "StoreTimeseriesVar",
    "build_container", "build_sharded_container",
    "save_archive", "save_sharded_archive",
    "open_archive", "memory_store_archive",
    "ArchiveWriter", "ensure_archive", "JOURNAL_NAME",
    "OpenOptions", "SessionOptions", "ReproDeprecationWarning",
    "segment_depth", "manifest_archive_id",
    "crc32c", "SegmentFetcher", "SegmentEntry", "FetchStats", "ChecksumError",
    "StoreHTTPServer",
    "RetryPolicy", "BlobQuarantine", "BlobQuarantinedError",
    "SegmentUnavailableError", "is_transient",
    "FaultPlan", "FaultInjectingByteStore", "FaultStats",
]
