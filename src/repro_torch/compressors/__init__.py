"""SZ-like snapshot compressors on tensors: the psz3 and psz3_delta
progressive ladders (counterpart of ``repro.compressors``)."""
from repro_torch.compressors.snapshots import (
    DeltaSnapshotArchive,
    SnapshotArchive,
    default_snapshot_eps,
)
from repro_torch.compressors.szlike import SZCompressed, sz_compress, \
    sz_decompress

__all__ = [
    "SZCompressed", "sz_compress", "sz_decompress",
    "SnapshotArchive", "DeltaSnapshotArchive", "default_snapshot_eps",
]
