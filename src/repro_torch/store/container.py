"""Archive containers (hb, ob, ip, psz3, psz3_delta): manifest + segment
payload(s), single-file or sharded.

Counterpart of ``repro/store/container.py``; the container format is the
reference's, byte for byte, so either package opens what the other wrote.
Layout of a single-file ``.prs`` container::

    magic  b"PRSTORE1"                          (8 bytes)
    manifest length, uint64 little-endian       (8 bytes)
    manifest JSON (utf-8)
    payload: concatenated segments

A *sharded* container is a directory (or URL prefix, or any set of
ByteStores) holding ``manifest.json`` plus one payload blob per shard — per
variable (``Vx.seg``) or per level group or snapshot (``Vx.g0.seg``,
``Vx.s0.seg``).

The manifest carries the method, per-variable group metadata (counts,
exponents, nbits, per-plane sizes, and an ip group's ``pred_planes``),
snapshot ladder metadata (per snapshot eps, shapes, levels, code dtypes,
amax and blob sizes), outlier-mask shapes and value ranges,
plus a segment index mapping ``key -> (blob, offset, size, crc32c, codec)``
(format v3).  v2 manifests carry ``(blob, offset, size, crc32c)`` and v1
manifests ``(offset, size, crc32c)`` with an implicit single blob; all
three parse, and v1/v2 plane payloads decode through the codec registry's
legacy paths.

``save_archive`` / ``save_sharded_archive`` serialize a port `Archive`;
``open_archive`` yields a `StoreArchive` whose ``open()`` returns a regular
`RetrievalSession` decoding on the archive's device — readers stream
checksum-verified segments through a `SegmentFetcher`, whose threads only
move bytes: inflation, the host -> device copy and every kernel launch stay
on the caller's thread and stream.  Reconstructions are bit-identical to an
in-memory session at every requested bound.

Live archives (format v4): a sharded directory may also carry an
append-only ``journal.jsonl`` next to ``manifest.json``.  The manifest
stays the v3-compatible base; every appended timestep adds one immutable
``V.t<k>.seg`` blob and journal records describing its segments.
``StoreArchive.refresh()`` re-reads the journal (over HTTP: a conditional
GET that costs one 304 when nothing changed) and applies only its complete
trailing records, so new timesteps become retrievable in an open session;
``repro_torch.store.writer.ArchiveWriter`` is the producing side.
Timeseries segments ``V/t<k>/b<j>`` decode through keyframe→delta chains
on the archive's device, and a retention record drops a keyframe-aligned
prefix of timesteps without touching what remains.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import urllib.parse
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.bitplane.codecs import blob_codec_id, codec_name
from repro_torch.bitplane.encoder import PlaneGroupMeta
from repro_torch.bitplane.segments import PlaneSource
from repro_torch.compressors.snapshots import (
    DeltaSnapshotArchive,
    DeltaSnapshotReader,
    SnapshotReader,
    decode_timestep,
    timestep_bound,
)
from repro_torch.compressors.szlike import SZCompressed, sz_decompress
from repro_torch.core.masks import OutlierMask
from repro_torch.core.refactor import (
    Archive,
    BitplaneVarArchive,
    RetrievalSession,
    SnapshotVarArchive,
    VarAvailability,
    _BitplaneVarReader,
    _resolve_session_options,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.options import OpenOptions, SessionOptions, _from_legacy
from repro_torch.store.bytestore import ByteStore, FileByteStore, \
    HTTPByteStore, MemoryByteStore
from repro_torch.store.cache import SegmentCache
from repro_torch.store.crc import crc32c
from repro_torch.store.fetcher import SegmentEntry, SegmentFetcher
from repro_torch.store.retry import BlobQuarantine, RetryPolicy
from repro_torch.transform.hierarchical import level_map

MAGIC = b"PRSTORE1"
FORMAT_VERSION = 4          # newest container format of the reference
STATIC_FORMAT_VERSION = 3   # what save_archive writes
MANIFEST_NAME = "manifest.json"
JOURNAL_NAME = "journal.jsonl"

SHARD_POLICIES = ("single", "variable", "group")


def segment_depth(key: str) -> int:
    """Progressive depth of a segment key — cache-eviction metadata.

    Bitplane segments ``V/g<l>/p<b>`` map to their plane index ``b`` (0 =
    MSB, consumed by every client; large = LSB, consumed by few); snapshot
    blobs ``V/s<i>/b<j>`` and timestep blobs ``V/t<k>/b<j>`` to ``i`` /
    ``k``.  Sign planes, masks and anything unrecognised map to 0 — they
    ride with the first plane and are as shared as the MSB prefix."""
    parts = key.split("/")
    last = parts[-1]
    if last[:1] == "p" and last[1:].isdigit():
        return int(last[1:])
    if len(parts) == 3 and parts[1][:1] in ("s", "t") \
            and parts[1][1:].isdigit() and last[:1] == "b":
        return int(parts[1][1:])
    return 0


def _shard_of(key: str, shard_by: str) -> str:
    """Map a segment key to its payload blob name under a shard policy.

    Keys look like ``Vx/g0/p3``, ``Vx/g0/signs``, ``Vx/s1/b0``,
    ``Vx/mask/bitmap`` — the first component is always the variable.
    """
    if shard_by == "single":
        return ""
    parts = key.split("/")
    var = parts[0]
    if shard_by == "variable":
        return f"{var}.seg"
    if shard_by == "group":
        if parts[1] == "mask":
            return f"{var}.meta.seg"
        return f"{var}.{parts[1]}.seg"      # g<l> (bitplane) / s<i> (snapshot)
    raise ValueError(f"unknown shard policy {shard_by!r}; "
                     f"choose from {SHARD_POLICIES}")


def _check_manifest(manifest: dict) -> None:
    if manifest.get("format") != "prstore":
        raise ValueError("not a prstore manifest")
    if manifest.get("version", 0) > FORMAT_VERSION:
        raise ValueError(f"container version {manifest.get('version')} "
                         f"newer than supported {FORMAT_VERSION}")


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


class _SegmentWriter:
    """Routes segments into per-shard payload blobs; builds the v3 index."""

    def __init__(self, shard_by: str = "single"):
        self.shard_by = shard_by
        self.index: Dict[str, List] = {}
        self._chunks: Dict[str, List[bytes]] = {}
        self._offsets: Dict[str, int] = {}

    def add(self, key: str, data: bytes, crc: Optional[int] = None,
            codec: Optional[int] = None) -> None:
        if key in self.index:
            raise ValueError(f"duplicate segment key {key!r}")
        blob = _shard_of(key, self.shard_by)
        off = self._offsets.get(blob, 0)
        self.index[key] = [blob, off, len(data),
                           crc32c(data) if crc is None else crc, codec]
        self._chunks.setdefault(blob, []).append(data)
        self._offsets[blob] = off + len(data)

    def payloads(self) -> Dict[str, bytes]:
        return {blob: b"".join(chunks)
                for blob, chunks in self._chunks.items()}


def _bitplane_var_manifest(name: str, var: BitplaneVarArchive,
                           w: _SegmentWriter) -> dict:
    groups = []
    for l, g in enumerate(var.groups):
        plane_crcs, sign_crc = g.segment_crcs()
        for b, blob in enumerate(g.planes):
            w.add(f"{name}/g{l}/p{b}", blob, crc=plane_crcs[b],
                  codec=blob_codec_id(blob))
        if g.exponent is not None:
            w.add(f"{name}/g{l}/signs", g.signs, crc=sign_crc,
                  codec=blob_codec_id(g.signs))
        spec = {"count": g.count, "exponent": g.exponent,
                "nbits": g.nbits,
                "plane_sizes": [len(p) for p in g.planes],
                "sign_size": len(g.signs)}
        if g.pred_planes is not None:       # ip prediction depth
            spec["pred_planes"] = g.pred_planes
        groups.append(spec)
    return {"kind": "bitplane", "method": var.method,
            "orig_shape": list(var.orig_shape),
            "padded_shape": list(var.padded_shape),
            "levels": var.levels, "groups": groups}


def _snapshot_var_manifest(name: str, var: SnapshotVarArchive,
                           w: _SegmentWriter) -> dict:
    arch = var.archive
    delta = isinstance(arch, DeltaSnapshotArchive)
    snaps = []
    for i, s in enumerate(arch.snapshots):
        for j, blob in enumerate(s.blobs):
            w.add(f"{name}/s{i}/b{j}", blob)
        snaps.append({"eps": s.eps, "orig_shape": list(s.orig_shape),
                      "padded_shape": list(s.padded_shape),
                      "levels": s.levels, "dtypes": list(s.dtypes),
                      "amax": s.amax,
                      "blob_sizes": [len(b) for b in s.blobs]})
    out = {"kind": "snapshot", "delta": delta, "snapshots": snaps}
    if delta:
        out["eps_ladder"] = list(arch.eps_ladder)
    return out


def build_sharded_container(archive: Archive,
                            shard_by: str = "variable"
                            ) -> Tuple[dict, Dict[str, bytes]]:
    """Archive -> (manifest dict, payload blobs keyed by blob name).  Every
    manifest value is a Python scalar, so ``json.dumps`` writes the
    reference's bytes."""
    w = _SegmentWriter(shard_by=shard_by)
    variables: Dict[str, dict] = {}
    for name, var in archive.variables.items():
        if "/" in name:
            raise ValueError(f"variable name {name!r} may not contain '/'")
        if isinstance(var, BitplaneVarArchive):
            variables[name] = _bitplane_var_manifest(name, var, w)
        elif isinstance(var, SnapshotVarArchive):
            variables[name] = _snapshot_var_manifest(name, var, w)
        else:
            raise TypeError(f"cannot serialize variable of type {type(var)}")
    masks: Dict[str, dict] = {}
    for name, m in archive.masks.items():
        w.add(f"{name}/mask/bitmap", np.packbits(m.mask.ravel()).tobytes())
        w.add(f"{name}/mask/values",
              np.ascontiguousarray(m.values, dtype=np.float64).tobytes())
        masks[name] = {"shape": list(m.mask.shape),
                       "n_true": int(m.mask.sum())}
    payloads = w.payloads()
    manifest = {
        "format": "prstore", "version": STATIC_FORMAT_VERSION,
        "method": archive.method,
        "ranges": dict(archive.ranges),
        "shapes": {k: list(v) for k, v in archive.shapes.items()},
        "masks": masks,
        "variables": variables,
        "segments": w.index,
        "blobs": {blob: len(data) for blob, data in payloads.items()},
    }
    return manifest, payloads


def build_container(archive: Archive) -> Tuple[dict, bytes]:
    """Archive -> (manifest dict, single payload bytes)."""
    manifest, payloads = build_sharded_container(archive, shard_by="single")
    return manifest, payloads.get("", b"")


def save_archive(archive: Archive, path: str) -> int:
    """Serialize ``archive`` into a container file; returns bytes written."""
    manifest, payload = build_container(archive)
    blob = json.dumps(manifest, sort_keys=True).encode("utf-8")
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        fh.write(payload)
    return len(MAGIC) + 8 + len(blob) + len(payload)


def save_sharded_archive(archive: Archive, directory: str,
                         shard_by: str = "variable") -> int:
    """Serialize ``archive`` as ``directory/manifest.json`` + one payload
    file per shard; returns total bytes written.  A variable can be dropped
    by deleting its blob(s) — sessions that never touch it keep working."""
    if shard_by == "single":
        raise ValueError("use save_archive for single-payload containers")
    manifest, payloads = build_sharded_container(archive, shard_by=shard_by)
    os.makedirs(directory, exist_ok=True)
    total = 0
    for blob, data in payloads.items():
        with open(os.path.join(directory, blob), "wb") as fh:
            fh.write(data)
        total += len(data)
    mblob = json.dumps(manifest, sort_keys=True, indent=1).encode("utf-8")
    with open(os.path.join(directory, MANIFEST_NAME), "wb") as fh:
        fh.write(mblob)
    return total + len(mblob)


# ---------------------------------------------------------------------------
# Store-backed variables (mirror the in-memory archive interfaces)
# ---------------------------------------------------------------------------


class FetcherPlaneSource(PlaneSource):
    """PlaneSource streaming one group's segments through a SegmentFetcher."""

    def __init__(self, fetcher: SegmentFetcher, prefix: str,
                 meta: PlaneGroupMeta):
        self.fetcher = fetcher
        self.prefix = prefix
        self.meta = meta

    def planes(self, start: int, stop: int) -> Sequence[bytes]:
        return self.fetcher.fetch_many(
            f"{self.prefix}/p{b}" for b in range(start, stop))

    def planes_available(self, start: int, stop: int):
        # degraded-mode path: deliver the longest contiguous plane prefix
        # instead of all-or-nothing (see SegmentFetcher.fetch_prefix)
        return self.fetcher.fetch_prefix(
            f"{self.prefix}/p{b}" for b in range(start, stop))

    def signs(self) -> bytes:
        return self.fetcher.fetch(f"{self.prefix}/signs")

    def prefetch(self, start: int, stop: int, certain: bool = True) -> None:
        keys = [f"{self.prefix}/p{b}" for b in range(start, stop)]
        if start == 0:               # signs ride with the first plane
            keys.append(f"{self.prefix}/signs")
        self.fetcher.prefetch(keys, certain=certain)


class StoreBitplaneVar:
    """Store-backed bitplane variable (hb, ob or ip): the reader-facing surface of
    `BitplaneVarArchive` (method, shapes, levels, groups, group_indices,
    plane_sources), with plane payloads left on the ByteStore."""

    def __init__(self, name: str, spec: dict, fetcher: SegmentFetcher):
        self.name = name
        self.method: str = spec["method"]
        self.orig_shape = tuple(spec["orig_shape"])
        self.padded_shape = tuple(spec["padded_shape"])
        self.levels: int = spec["levels"]
        self.groups: List[PlaneGroupMeta] = [
            PlaneGroupMeta(count=g["count"], exponent=g["exponent"],
                           nbits=g["nbits"],
                           plane_sizes=tuple(g["plane_sizes"]),
                           sign_size=g["sign_size"],
                           pred_planes=g.get("pred_planes"))
            for g in spec["groups"]]
        self._fetcher = fetcher
        self._indices: Optional[List[np.ndarray]] = None

    @property
    def group_indices(self) -> List[np.ndarray]:
        # a deterministic function of (padded_shape, levels), recomputed
        # instead of stored, exactly as the refactor computed it
        if self._indices is None:
            lmap = level_map(self.padded_shape, self.levels).ravel()
            self._indices = [np.flatnonzero(lmap == l)
                             for l in range(self.levels + 1)]
        return self._indices

    @property
    def total_nbytes(self) -> int:
        return sum(sum(g.plane_sizes) + g.sign_size for g in self.groups)

    def plane_sources(self) -> List[PlaneSource]:
        return [FetcherPlaneSource(self._fetcher, f"{self.name}/g{l}", meta)
                for l, meta in enumerate(self.groups)]

    def open_reader(self, options: Optional[SessionOptions] = None,
                    device: DeviceLike = None,
                    **legacy) -> _BitplaneVarReader:
        opts = _resolve_session_options(options, legacy,
                                        "StoreBitplaneVar.open_reader")
        # the fetcher's FetchStats doubles as the ContribStats sink so one
        # object reports transport traffic AND reader residency/spills
        return _BitplaneVarReader(
            self, resolve_device(device),
            contrib_budget_bytes=opts.contrib_budget_bytes,
            contrib_stats=self._fetcher.stats,
            contrib_pool=opts.contrib_pool,
            decode_batcher=opts.decode_batcher)


class _SnapshotHandle:
    """Manifest-only view of one SZ snapshot: selection metadata resident,
    blobs fetched (verified) on load."""

    def __init__(self, name: str, idx: int, spec: dict,
                 fetcher: SegmentFetcher):
        self.eps: float = spec["eps"]
        self.amax: float = spec["amax"]
        self._spec = spec
        self._keys = [f"{name}/s{idx}/b{j}"
                      for j in range(len(spec["blob_sizes"]))]
        self._fetcher = fetcher
        self._loaded: Optional[SZCompressed] = None

    @property
    def nbytes(self) -> int:
        return sum(self._spec["blob_sizes"]) + 64  # + header, as SZCompressed

    @property
    def safe_eps(self) -> float:
        return self.eps + 8 * np.finfo(np.float64).eps * self.amax

    def prefetch(self, certain: bool = True) -> None:
        self._fetcher.prefetch(self._keys, certain=certain)

    def load(self) -> SZCompressed:
        if self._loaded is None:
            blobs = self._fetcher.fetch_many(self._keys)
            s = self._spec
            self._loaded = SZCompressed(
                eps=s["eps"], orig_shape=tuple(s["orig_shape"]),
                padded_shape=tuple(s["padded_shape"]), levels=s["levels"],
                blobs=blobs, dtypes=list(s["dtypes"]), amax=s["amax"])
        return self._loaded


class _StoreSnapshotReader(SnapshotReader):
    def __init__(self, archive, device: torch.device):
        super().__init__(archive, device)
        self._pin_error: Optional[BaseException] = None

    def _decode(self, idx: int) -> torch.Tensor:
        return sz_decompress(self.archive.snapshots[idx].load(), self.device)

    @property
    def is_degraded(self) -> bool:
        return self._pin_error is not None

    def availability(self) -> VarAvailability:
        if self._pin_error is None:
            return VarAvailability(
                pinned=False, floor=self.archive.snapshots[-1].safe_eps)
        floor = self.archive.snapshots[self._cache[0]].safe_eps \
            if self._cache is not None else float("inf")
        return VarAvailability(pinned=True, floor=floor,
                               detail=str(self._pin_error))

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        if self._pin_error is not None and self._cache is not None:
            # availability-pinned: serve the deepest decoded snapshot — its
            # bound is still a valid certificate, just wider
            idx = self._cache[0]
            return self._cache[1], self.archive.snapshots[idx].safe_eps
        try:
            return super().request(eps)
        except Exception as e:
            if self._cache is None:
                raise          # nothing decoded yet: nothing to certify
            self._pin_error = e
            idx = self._cache[0]
            return self._cache[1], self.archive.snapshots[idx].safe_eps

    def prefetch_eps(self, eps: float, certain: bool = True) -> None:
        # Independent snapshots are NOT prefix-monotone: a *predicted* eps
        # that undershoots the landing state would move a whole snapshot
        # that is never decoded.  Only act on certain hints.
        if not certain:
            return
        idx = self._select(eps)
        # mirror request()'s never-go-backwards rule: a request at or below
        # an already-decoded snapshot reuses it and decodes nothing new
        if self._cache is not None and self._cache[0] >= idx:
            return
        if not self.fetched[idx]:
            self.archive.snapshots[idx].prefetch()


class _StoreDeltaSnapshotReader(DeltaSnapshotReader):
    def __init__(self, archive, device: torch.device):
        super().__init__(archive, device)
        self._pin_error: Optional[BaseException] = None

    def _decode(self, idx: int) -> torch.Tensor:
        return sz_decompress(self.archive.snapshots[idx].load(), self.device)

    @property
    def is_degraded(self) -> bool:
        return self._pin_error is not None

    def availability(self) -> VarAvailability:
        if self._pin_error is None:
            snaps = self.archive.snapshots
            tight = snaps[-1]
            slack = 8 * np.finfo(np.float64).eps * tight.amax * len(snaps)
            return VarAvailability(pinned=False, floor=tight.eps + slack)
        floor = self.achieved_bound() if self.n_fetched else float("inf")
        return VarAvailability(pinned=True, floor=floor,
                               detail=str(self._pin_error))

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        if self._pin_error is not None and self.n_fetched:
            # pinned: the residual ladder ends at the deepest applied rung
            return self._decoded, self.achieved_bound()
        try:
            return super().request(eps)
        except Exception as e:
            if self.n_fetched == 0:
                raise          # no rung applied: nothing to certify
            self._pin_error = e
            return self._decoded, self.achieved_bound()

    def prefetch_eps(self, eps: float, certain: bool = True) -> None:
        # The residual ladder is cumulative (request(eps) consumes ALL
        # snapshots up to the selected index), so even a speculative
        # prediction prefetches a prefix of what any tighter landing state
        # will consume — byte-safe either way.
        idx = self._select(eps)
        for i in range(self.n_fetched, idx + 1):
            self.archive.snapshots[i].prefetch(certain=certain)


class StoreSnapshotVar:
    """Store-backed psz3 / psz3_delta variable: snapshot handles whose
    blobs stay on the ByteStore until a reader decodes them."""

    def __init__(self, name: str, spec: dict, fetcher: SegmentFetcher):
        self.name = name
        self.delta: bool = spec["delta"]
        self.snapshots = [_SnapshotHandle(name, i, s, fetcher)
                          for i, s in enumerate(spec["snapshots"])]
        self.eps_ladder = list(spec.get("eps_ladder", []))

    @property
    def total_nbytes(self) -> int:
        return sum(h.nbytes for h in self.snapshots)

    def open_reader(self, options: Optional[SessionOptions] = None,
                    device: DeviceLike = None, **legacy):
        # contribution budgets/pools are bitplane-reader state; the options
        # object is accepted (and validated) for interface uniformity
        _resolve_session_options(options, legacy,
                                 "StoreSnapshotVar.open_reader")
        cls = _StoreDeltaSnapshotReader if self.delta else _StoreSnapshotReader
        return cls(self, resolve_device(device))


# ---------------------------------------------------------------------------
# Timeseries variables (format v4: journaled, append-only)
# ---------------------------------------------------------------------------


class _TimestepHandle:
    """Manifest/journal-only view of one appended timestep: chain metadata
    resident, payload blobs fetched (verified) on decode."""

    def __init__(self, name: str, spec: dict, fetcher: SegmentFetcher):
        self.t: int = spec["t"]
        self.keyframe: bool = spec["keyframe"]
        self.eps: float = spec["eps"]
        self.amax: float = spec["amax"]
        self._spec = spec
        self._keys = [f"{name}/t{self.t}/b{j}"
                      for j in range(len(spec["blob_sizes"]))]
        self._fetcher = fetcher
        self._loaded: Optional[SZCompressed] = None

    @property
    def nbytes(self) -> int:
        return sum(self._spec["blob_sizes"]) + 64  # + header, as SZCompressed

    @property
    def segment_keys(self) -> List[str]:
        return list(self._keys)

    def load(self) -> SZCompressed:
        if self._loaded is None:
            blobs = self._fetcher.fetch_many(self._keys)
            s = self._spec
            self._loaded = SZCompressed(
                eps=s["eps"], orig_shape=tuple(s["orig_shape"]),
                padded_shape=tuple(s["padded_shape"]), levels=s["levels"],
                blobs=blobs, dtypes=list(s["dtypes"]), amax=s["amax"])
        return self._loaded


class StoreTimeseriesVar:
    """Store-backed live timeseries variable (format v4).

    Timesteps arrive through journal replay: each is a keyframe or a delta
    against its predecessor's reconstruction.  ``base_t`` is the oldest
    retained timestep, always a keyframe, advanced by retention records.
    The list only grows at the tail and shrinks at the head, so a reader
    holding an index into it stays valid across concurrent ``refresh()``
    calls."""

    kind = "timeseries"

    def __init__(self, name: str, spec: dict, fetcher: SegmentFetcher):
        self.name = name
        self._fetcher = fetcher
        self.base_t: int = spec.get("base_t", 0)
        self.timesteps: List[_TimestepHandle] = [
            _TimestepHandle(name, ts, fetcher)
            for ts in spec.get("timesteps", [])]

    @property
    def total_nbytes(self) -> int:
        return sum(h.nbytes for h in self.timesteps)

    @property
    def latest_t(self) -> Optional[int]:
        return self.timesteps[-1].t if self.timesteps else None

    def handle(self, t: int) -> _TimestepHandle:
        i = t - self.base_t
        if i < 0:
            raise KeyError(f"{self.name}: timestep {t} dropped by retention "
                           f"(oldest retained is {self.base_t})")
        if i >= len(self.timesteps):
            raise KeyError(f"{self.name}: timestep {t} not (yet) in the "
                           f"journal — latest is {self.latest_t}")
        return self.timesteps[i]

    def add_timestep(self, spec: dict) -> None:
        expect = self.base_t + len(self.timesteps)
        if spec["t"] != expect:
            raise ValueError(f"{self.name}: journal timestep {spec['t']} "
                             f"out of order (expected {expect})")
        if not spec["keyframe"] and not self.timesteps:
            raise ValueError(f"{self.name}: delta timestep {spec['t']} "
                             f"has no retained predecessor")
        self.timesteps.append(_TimestepHandle(self.name, spec, self._fetcher))

    def drop_before(self, t: int) -> List[str]:
        """Apply a retention record: forget timesteps ``< t`` and return
        their segment keys for the caller to drop from the fetch index.
        ``t`` must land on a keyframe, or the remaining chain would
        dangle."""
        if t <= self.base_t:
            return []
        n = min(t - self.base_t, len(self.timesteps))
        if n < len(self.timesteps) and not self.timesteps[n].keyframe:
            raise ValueError(f"{self.name}: retention boundary t={t} is not "
                             f"a keyframe — remaining chain would dangle")
        dropped: List[str] = []
        for h in self.timesteps[:n]:
            dropped.extend(h.segment_keys)
        del self.timesteps[:n]
        self.base_t += n
        return dropped

    def open_reader(self, options: Optional[SessionOptions] = None,
                    device: DeviceLike = None,
                    **legacy) -> "_TimeseriesReader":
        _resolve_session_options(options, legacy,
                                 "StoreTimeseriesVar.open_reader")
        return _TimeseriesReader(self, resolve_device(device))


class _TimeseriesReader:
    """Chain-decoding reader over a (possibly growing) timeseries variable,
    decoding on ``device``.

    ``read(t)`` decodes timestep ``t`` through its keyframe→delta chain and
    reuses the previous reconstruction when ``t`` continues the cached
    chain, so a follow-mode session walking t, t+1, t+2 pays one delta
    decode per step — which makes it bit- and byte-identical to a one-shot
    session reading the same timesteps.  ``request(eps)`` serves the
    session interface with the latest visible timestep."""

    def __init__(self, var: StoreTimeseriesVar, device: torch.device):
        self.var = var
        self.device = device
        self.bytes_fetched = 0
        self._charged: set = set()                     # timestep indices
        self._chain: Optional[Tuple[int, torch.Tensor]] = None  # (t, recon)

    def _charge(self, h: _TimestepHandle) -> None:
        if h.t not in self._charged:
            self.bytes_fetched += h.nbytes
            self._charged.add(h.t)

    def read(self, t: int) -> Tuple[torch.Tensor, float]:
        """Decode timestep ``t``; returns ``(data, certified L-inf bound)``."""
        h = self.var.handle(t)
        # the chain starts at the latest keyframe at or before t, or after
        # the cached reconstruction if that is an ancestor on the chain
        start = t
        while not self.var.handle(start).keyframe:
            start -= 1
        prev: Optional[torch.Tensor] = None
        begin = start
        if self._chain is not None and start <= self._chain[0] <= t:
            begin, prev = self._chain[0] + 1, self._chain[1]
        for k in range(begin, t + 1):
            hk = self.var.handle(k)
            snap = hk.load()            # fetches (verified) on first touch
            prev = decode_timestep(snap, None if hk.keyframe else prev,
                                   self.device)
            self._charge(hk)
        self._chain = (t, prev)
        amaxes = [self.var.handle(k).amax for k in range(start, t + 1)]
        return prev, timestep_bound(h.eps, amaxes)

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        latest = self.var.latest_t
        if latest is None:
            raise KeyError(f"{self.var.name}: no timesteps appended yet "
                           f"(refresh() the archive or append first)")
        return self.read(latest)


# ---------------------------------------------------------------------------
# StoreArchive
# ---------------------------------------------------------------------------


class _LazyMasks:
    """Mapping-like mask access that fetches (and verifies) mask segments on
    first use — a session that never touches a variable never moves its
    mask."""

    def __init__(self, specs: Dict[str, dict], fetcher: SegmentFetcher):
        self._specs = specs
        self._fetcher = fetcher
        self._cache: Dict[str, OutlierMask] = {}
        # variable -> first fetch failure: a permanently missing mask
        # degrades to "no mask" — masked points are fully present in the
        # progressive encoding (the mask only overlays their exact values),
        # so serving the un-patched reconstruction under the plane bound
        # stays certified; only the eb_array's exact-point zeros are lost
        self._pinned: Dict[str, BaseException] = {}

    def get(self, name: str) -> Optional[OutlierMask]:
        if name not in self._specs or name in self._pinned:
            return None
        if name not in self._cache:
            spec = self._specs[name]
            shape = tuple(spec["shape"])
            try:
                bitmap = self._fetcher.fetch(f"{name}/mask/bitmap")
                # a writable copy: torch wraps it for the device transfer
                values = np.frombuffer(
                    self._fetcher.fetch(f"{name}/mask/values"),
                    dtype=np.float64, count=spec["n_true"]).copy()
            except Exception as e:
                self._pinned[name] = e
                return None
            mask = np.unpackbits(
                np.frombuffer(bitmap, dtype=np.uint8),
                count=int(np.prod(shape))).astype(bool).reshape(shape)
            self._cache[name] = OutlierMask(mask=mask, values=values)
        return self._cache[name]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __getitem__(self, name: str) -> OutlierMask:
        m = self.get(name)
        if m is None:
            raise KeyError(name)
        return m

    def keys(self):
        return self._specs.keys()

    def values(self):
        return [self[k] for k in self._specs]


StoreSpec = Union[ByteStore, Dict[str, ByteStore],
                  Callable[[str], ByteStore]]


def _parse_segment_index(manifest: dict, payload_offset: int,
                         with_depth: bool = True
                         ) -> Dict[str, SegmentEntry]:
    """v3 entries are (blob, offset, size, crc, codec); v2 drop the codec
    field; v1 are (offset, size, crc) with an implicit single blob ``""``
    — all three parse (codec stays None on v1/v2, whose payloads are
    self-describing through the legacy tag bytes).  ``payload_offset``
    shifts only the single-file blob (whose payload follows the in-file
    manifest).  ``with_depth=False`` skips the per-key depth parse — depth
    is cache eviction metadata, dead weight on a cache-less open."""
    index: Dict[str, SegmentEntry] = {}
    for key, entry in manifest["segments"].items():
        codec = None
        if len(entry) == 5:
            blob, off, size, crc, codec = entry
        elif len(entry) == 4:
            blob, off, size, crc = entry
        else:
            blob, (off, size, crc) = "", entry
        index[key] = SegmentEntry(
            offset=off + (payload_offset if blob == "" else 0),
            size=size, crc=crc, blob=blob,
            depth=segment_depth(key) if with_depth else 0,
            codec=codec)
    return index


def manifest_archive_id(manifest: dict) -> str:
    """Stable id grouping one archive's cache entries for per-archive
    budgets: a hash of the canonical manifest JSON, so every session over
    the same container (local, re-opened, or remote) lands in the same
    budget group while distinct archives never collide on id *and* crc."""
    blob = json.dumps(manifest, sort_keys=True).encode("utf-8")
    return f"prs-{zlib.crc32(blob):08x}-{len(blob)}"


class StoreArchive:
    """An archive whose segments live on one or more ByteStores;
    ``open()`` returns a regular RetrievalSession streaming through the
    SegmentFetcher and decoding on ``device``.

    ``store`` may be a single ByteStore (single-blob containers), a mapping
    ``blob name -> ByteStore`` (sharded, backends may differ per shard), or
    a resolver callable ``blob name -> ByteStore`` invoked lazily on first
    touch — sessions that never read a shard never open (or require) it.
    ``cache`` is an optional cross-session `SegmentCache`.

    ``journal_source`` (live v4 archives) is a zero-argument callable
    returning the current full journal bytes, re-read on every
    ``refresh()``: local opens re-read the file, HTTP opens go through
    ``HTTPByteStore.read_all``'s conditional GET.
    """

    def __init__(self, manifest: dict, store: StoreSpec,
                 device: DeviceLike = None,
                 payload_offset: int = 0, prefetch_workers: int = 2,
                 verify: bool = True,
                 cache: Optional[SegmentCache] = None,
                 archive_id: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 quarantine: Optional[BlobQuarantine] = None,
                 journal_source: Optional[Callable[[], bytes]] = None):
        self.device = resolve_device(device)
        _check_manifest(manifest)
        self.manifest = manifest
        self.method: str = manifest["method"]
        self.ranges: Dict[str, float] = dict(manifest["ranges"])
        self.shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(v) for k, v in manifest["shapes"].items()}
        # the id only matters as a cache grouping key: derive it eagerly
        # only when a cache will consume it.  A live archive pins it now:
        # journal replay changes the manifest dict (blob sizes), and the
        # grouping id must not drift as the archive grows
        if archive_id is None and (cache is not None
                                   or journal_source is not None):
            archive_id = manifest_archive_id(manifest)
        self._archive_id = archive_id
        index = _parse_segment_index(manifest, payload_offset,
                                     with_depth=cache is not None)
        # store-backed sessions get the hardened fault-tolerance defaults:
        # retries with jittered backoff, and a circuit breaker whose
        # threshold sits above one segment's full retry budget
        if retry_policy is None:
            retry_policy = RetryPolicy()
        if quarantine is None:
            quarantine = BlobQuarantine(
                threshold=2 * retry_policy.max_attempts)
        self.retry_policy = retry_policy
        self.quarantine = quarantine
        self.fetcher = SegmentFetcher(index, store,
                                      prefetch_workers=prefetch_workers,
                                      verify=verify, cache=cache,
                                      archive_id=archive_id or "",
                                      retry_policy=retry_policy,
                                      quarantine=quarantine)
        self.masks = _LazyMasks(manifest["masks"], self.fetcher)
        self.variables: Dict[str, object] = {}
        for name, spec in manifest["variables"].items():
            if spec["kind"] == "bitplane":
                self.variables[name] = StoreBitplaneVar(name, spec,
                                                        self.fetcher)
            elif spec["kind"] == "timeseries":
                self.variables[name] = StoreTimeseriesVar(name, spec,
                                                          self.fetcher)
            else:
                self.variables[name] = StoreSnapshotVar(name, spec,
                                                        self.fetcher)
        # -- live-archive (v4 journal) state --------------------------------
        self.sealed: bool = bool(manifest.get("sealed", False))
        self._journal_source = journal_source
        # a consolidated manifest records how many leading journal records
        # it already folded in; replay starts past them
        self._journal_skip: int = int(manifest.get("journal_records", 0))
        self._refresh_mu = threading.Lock()
        if journal_source is not None and not self.sealed:
            self.refresh()

    # -- live archives (journal replay) --------------------------------------

    def refresh(self) -> int:
        """Re-read the journal and apply the records appended since the
        last refresh (or open); returns how many were applied.  Only
        complete lines count — a tail record the writer is still writing
        waits for the next refresh.  Static and sealed archives return 0
        without touching the store."""
        if self._journal_source is None or self.sealed:
            return 0
        with self._refresh_mu:
            raw = self._journal_source()
            lines = raw.split(b"\n")[:-1]   # drop the unterminated tail
            records = lines[self._journal_skip:]
            applied = 0
            for line in records:
                line = line.strip()
                if line:
                    self._apply_journal_record(json.loads(line))
                applied += 1
            self._journal_skip += applied
            return applied

    def _apply_journal_record(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "segment":
            key = rec["key"]
            self.fetcher.add_segments({key: SegmentEntry(
                offset=rec["offset"], size=rec["size"], crc=rec["crc"],
                blob=rec["blob"], depth=segment_depth(key),
                codec=rec.get("codec"))})
            # keep the manifest's blob sizes current: the lazy HTTP blob
            # resolver reads them to skip per-blob HEAD probes
            blobs = self.manifest.setdefault("blobs", {})
            blobs[rec["blob"]] = max(blobs.get(rec["blob"], 0),
                                     rec["offset"] + rec["size"])
        elif op == "var":
            name = rec["name"]
            if name not in self.variables:
                self.variables[name] = StoreTimeseriesVar(
                    name, {"kind": "timeseries"}, self.fetcher)
                self.shapes[name] = tuple(rec["shape"])
                self.ranges[name] = rec["range"]
        elif op == "timestep":
            var = self.variables[rec["var"]]
            if not isinstance(var, StoreTimeseriesVar):
                raise ValueError(f"journal timestep for non-timeseries "
                                 f"variable {rec['var']!r}")
            var.add_timestep(rec)
        elif op == "retention":
            var = self.variables[rec["var"]]
            self.fetcher.remove_segments(var.drop_before(rec["base_t"]))
        elif op == "seal":
            self.sealed = True
        else:
            raise ValueError(f"unknown journal op {op!r}")

    @property
    def archive_id(self) -> str:
        if self._archive_id is None:
            self._archive_id = manifest_archive_id(self.manifest)
        return self._archive_id

    @property
    def cache(self) -> Optional[SegmentCache]:
        return self.fetcher.cache

    @property
    def total_nbytes(self) -> int:
        return sum(e.size for e in self.fetcher.index.values())

    def codec_bytes(self) -> Dict[str, int]:
        """Encoder-side codec choice: archived bytes per entropy codec,
        straight from the manifest (no payload reads).  v1/v2 archives
        report everything as ``untagged``."""
        out: Dict[str, int] = {}
        for e in self.fetcher.index.values():
            name = codec_name(e.codec)
            out[name] = out.get(name, 0) + e.size
        return out

    def n_elements(self, name: str) -> int:
        return int(np.prod(self.shapes[name]))

    def open(self, options: Optional[SessionOptions] = None,
             **legacy) -> RetrievalSession:
        opts = _resolve_session_options(options, legacy, "StoreArchive.open")
        return RetrievalSession(self, opts)

    def close(self) -> None:
        self.fetcher.close()
        self.fetcher.close_stores()

    def __enter__(self) -> "StoreArchive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def is_url(source: str) -> bool:
    return source.startswith(("http://", "https://"))


def _resolve_open_options(options: Optional[OpenOptions],
                          legacy: dict, where: str) -> OpenOptions:
    """The OpenOptions counterpart of ``_resolve_session_options``."""
    if legacy:
        if options is not None:
            raise TypeError(f"{where}: pass either an OpenOptions object or "
                            f"legacy keyword arguments, not both")
        return _from_legacy(OpenOptions, legacy, where)
    return options if options is not None else OpenOptions()


def _journal_manifest(manifest: dict) -> bool:
    """Does this manifest advertise a live journal worth tailing?"""
    return bool(manifest.get("journal")) and not manifest.get("sealed")


def open_archive(source, options: Optional[OpenOptions] = None,
                 device: DeviceLike = None, **legacy) -> StoreArchive:
    """Open a container — single-file, sharded, local, or over HTTP — whose
    sessions decode on ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).

    ``source`` may be:

      * a ``.prs`` file path — manifest parsed from the file head, segment
        reads through a mmap'd FileByteStore;
      * a directory (or explicit ``manifest.json`` path) — sharded archive;
        blobs default to FileByteStores next to the manifest;
      * an ``http(s)://`` URL — of a ``manifest.json`` (sharded; blobs
        default to HTTPByteStores resolved relative to the manifest URL) or
        of a single ``.prs`` resource (ranged GETs through HTTPByteStore);
      * a manifest dict — blobs come from ``options.blob_resolver``;
      * an already-constructed ByteStore — the container header is read
        through the store, so its transfer is accounted like any other read.

    ``options`` is an :class:`repro_torch.options.OpenOptions` bundling the
    transport/integrity knobs and journal following.  The pre-v4 loose
    keyword arguments still work through a once-warning deprecation shim.

    A live (journaled, unsealed) sharded archive opens at its current
    journal tail; ``StoreArchive.refresh()`` picks up later appends —
    locally by re-reading ``journal.jsonl``, over HTTP by a conditional GET
    that costs one 304 when nothing changed.
    """
    opts = _resolve_open_options(options, legacy, "open_archive")
    dev = resolve_device(device)
    blob_resolver = opts.blob_resolver

    def build(manifest: dict, default: Optional[StoreSpec],
              payload_offset: int = 0,
              journal_source: Optional[Callable[[], bytes]] = None
              ) -> StoreArchive:
        return StoreArchive(manifest, blob_resolver or default, device=dev,
                            payload_offset=payload_offset,
                            prefetch_workers=opts.prefetch_workers,
                            verify=opts.verify, cache=opts.cache,
                            archive_id=opts.archive_id,
                            retry_policy=opts.retry_policy,
                            quarantine=opts.quarantine,
                            journal_source=journal_source)

    def http_store(url: str, **kw) -> HTTPByteStore:
        if opts.retry_policy is not None:
            kw["retry_policy"] = opts.retry_policy
        return HTTPByteStore(url, **kw)

    if isinstance(source, dict):
        if blob_resolver is None:
            raise ValueError("a manifest dict needs a blob_resolver")
        return build(source, None)

    if isinstance(source, str) and is_url(source):
        # detect on the parsed path, not the raw string — signed /
        # parameterized URLs carry query strings after the filename
        if urllib.parse.urlsplit(source).path.endswith(".json"):
            with http_store(source) as ms:
                manifest = json.loads(ms.read_all().decode("utf-8"))
            journal_source = None
            if opts.follow and _journal_manifest(manifest):
                # a persistent store: read_all's ETag makes every poll of an
                # unchanged journal a 304 header exchange
                js = http_store(urllib.parse.urljoin(source, JOURNAL_NAME))
                journal_source = js.read_all
            # blob sizes are recorded in the manifest (and kept current by
            # journal replay), so shard stores skip their HEAD probe (one
            # GET per first-touched shard)
            blob_sizes = manifest.get("blobs", {})
            return build(manifest, lambda blob: http_store(
                urllib.parse.urljoin(source, blob),
                size=blob_sizes.get(blob)),
                journal_source=journal_source)
        source = http_store(source)

    if isinstance(source, str):
        if os.path.isdir(source) or source.endswith(".json"):
            mpath = source if source.endswith(".json") \
                else os.path.join(source, MANIFEST_NAME)
            with open(mpath, "rb") as fh:
                manifest = json.loads(fh.read().decode("utf-8"))
            root = os.path.dirname(os.path.abspath(mpath))
            journal_source = None
            if opts.follow and _journal_manifest(manifest):
                jpath = os.path.join(root, JOURNAL_NAME)

                def journal_source() -> bytes:
                    try:
                        with open(jpath, "rb") as jf:
                            return jf.read()
                    except FileNotFoundError:
                        return b""
            return build(manifest, lambda blob: FileByteStore(
                os.path.join(root, blob)), journal_source=journal_source)
        source = FileByteStore(source)

    # single-blob container: parse the header through the store itself
    store = source
    try:
        head = store.read(0, len(MAGIC) + 8)
        if head[:len(MAGIC)] != MAGIC:
            raise ValueError("bad magic: not a PRSTORE container")
        (mlen,) = struct.unpack("<Q", head[len(MAGIC):])
        manifest = json.loads(
            store.read(len(MAGIC) + 8, mlen).decode("utf-8"))
        spec: StoreSpec = store if blob_resolver is None else (
            lambda blob: store if blob == "" else blob_resolver(blob))
        return StoreArchive(manifest, spec, device=dev,
                            payload_offset=len(MAGIC) + 8 + mlen,
                            prefetch_workers=opts.prefetch_workers,
                            verify=opts.verify, cache=opts.cache,
                            archive_id=opts.archive_id,
                            retry_policy=opts.retry_policy,
                            quarantine=opts.quarantine)
    except BaseException:
        store.close()
        raise


def memory_store_archive(archive: Archive,
                         options: Optional[OpenOptions] = None,
                         shard_by: str = "single",
                         device: DeviceLike = None,
                         **legacy) -> StoreArchive:
    """Round an in-memory Archive through the container format without
    touching disk (tests, benchmarks); sessions decode on ``device``
    (default CUDA).  ``shard_by`` exercises the sharded manifest with one
    MemoryByteStore per blob."""
    opts = _resolve_open_options(options, legacy, "memory_store_archive")
    dev = resolve_device(device)
    manifest, payloads = build_sharded_container(archive, shard_by=shard_by)
    manifest = json.loads(json.dumps(manifest))   # exact same path as disk
    stores = {blob: MemoryByteStore(data) for blob, data in payloads.items()}
    spec: StoreSpec = stores if shard_by != "single" else stores.get(
        "", MemoryByteStore(b""))
    return StoreArchive(manifest, spec, device=dev,
                        prefetch_workers=opts.prefetch_workers,
                        verify=opts.verify, cache=opts.cache,
                        archive_id=opts.archive_id,
                        retry_policy=opts.retry_policy,
                        quarantine=opts.quarantine)
