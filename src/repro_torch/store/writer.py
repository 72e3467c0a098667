"""ArchiveWriter: the producing side of live append-only archives (v4).

Counterpart of ``repro/store/writer.py``; the directory it writes is the
reference writer's, byte for byte, for the same frames and settings:

    w = ArchiveWriter.create(dirpath)           # base manifest + journal
    w.append({"Vx": frame0}, eps=1e-3)          # keyframe
    w.append({"Vx": frame1}, eps=1e-3)          # delta vs. recon(frame0)
    ...
    w.seal()                                    # consolidated manifest

Every ``append`` compresses each variable's new timestep through
``repro_torch.compressors.snapshots.encode_timestep`` on the writer's device
— a keyframe every ``keyframe_interval`` steps, residuals against the
previous timestep's *reconstruction* in between, which stays on the device
— writes the payload as one new immutable ``<var>.t<k>.seg`` blob, and
appends the describing records to ``journal.jsonl``.  Nothing already on
disk is rewritten: the base ``manifest.json`` stays fixed until ``seal()``,
blobs are published by rename, and the journal only grows, so a concurrent
reader (a local re-read or an HTTP conditional GET — see
``StoreArchive.refresh``) sees a record completely or not yet.

``retain_timesteps`` enables rolling retention: once a variable holds more
than that many timesteps, the oldest keyframe-aligned prefix is dropped —
a ``retention`` record tells readers to forget it, and the dropped blobs
are deleted.

``seal()`` appends the terminal record and atomically rewrites
``manifest.json`` as a consolidated v4 manifest (``"sealed": true``,
``"journal_records": N``), so a sealed archive opens without the journal.

Manifest and journal hold Python floats and ints only (``json.dumps`` with
``sort_keys``), each the same value the reference computes: a range is
``float`` of one float64 subtraction, and eps and amax come from
``SZCompressed`` as floats.

``ensure_archive`` serializes create-if-missing across racing processes
behind a lockfile; the builder runs once and its result is published by one
atomic rename.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.compressors.snapshots import encode_timestep
from repro_torch.compressors.szlike import as_device_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.container import (
    FORMAT_VERSION,
    JOURNAL_NAME,
    MANIFEST_NAME,
    build_sharded_container,
    is_url,
    save_archive,
    save_sharded_archive,
)
from repro_torch.store.crc import crc32c

__all__ = ["ArchiveWriter", "ensure_archive"]


def _write_atomic(path: str, data: bytes) -> None:
    """Publish ``data`` at ``path`` by rename — readers see old or new
    bytes, never a prefix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


class _VarState:
    """Writer-side chain state for one timeseries variable; the previous
    reconstruction stays on the writer's device."""

    __slots__ = ("shape", "next_t", "since_key", "prev_recon")

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape
        self.next_t = 0
        self.since_key = 0                      # deltas since last keyframe
        self.prev_recon: Optional[torch.Tensor] = None


class ArchiveWriter:
    """Append-only producer of a live sharded archive (manifest v4) whose
    compression runs on ``device``.

    Construct through :meth:`create`.  ``append`` adds one timestep per
    supplied variable (each variable keeps its own clock); ``seal``
    finalizes.  The writer keeps the consolidated manifest in memory, so
    ``seal()`` is a local rewrite with no journal re-read.
    """

    def __init__(self, directory: str, manifest: dict,
                 keyframe_interval: int = 8,
                 retain_timesteps: Optional[int] = None,
                 device: DeviceLike = None,
                 _journal_records: int = 0):
        if keyframe_interval < 1:
            raise ValueError("keyframe_interval must be >= 1")
        if retain_timesteps is not None and retain_timesteps < 1:
            raise ValueError("retain_timesteps must be >= 1 (or None)")
        self.device = resolve_device(device)
        self.directory = directory
        self.manifest = manifest
        self.keyframe_interval = keyframe_interval
        self.retain_timesteps = retain_timesteps
        self.sealed = bool(manifest.get("sealed", False))
        self.bytes_written = 0
        self._vars: Dict[str, _VarState] = {}
        self._journal_records = _journal_records
        self._jf = open(os.path.join(directory, JOURNAL_NAME), "ab")

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, directory: str, base=None, method: str = "hb",
               shard_by: str = "variable", keyframe_interval: int = 8,
               retain_timesteps: Optional[int] = None,
               device: DeviceLike = None) -> "ArchiveWriter":
        """Create a live archive at ``directory`` whose appends compress on
        ``device`` (default CUDA; raises without it unless
        ``device="cpu"``).

        ``base`` (optional, a port ``core.refactor.Archive``) seeds the
        archive with a one-shot refactor — the v3-compatible static content
        — so ``create(d, base=a); seal()`` subsumes ``save_sharded_archive``.
        Without a base the archive starts empty and grows by appends.  The
        directory must not already hold a manifest."""
        dev = resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        mpath = os.path.join(directory, MANIFEST_NAME)
        if os.path.exists(mpath):
            raise FileExistsError(f"{mpath} exists — ArchiveWriter never "
                                  f"rewrites a published archive")
        if base is not None:
            manifest, payloads = build_sharded_container(base,
                                                         shard_by=shard_by)
            for blob, data in payloads.items():
                _write_atomic(os.path.join(directory, blob), data)
        else:
            manifest = {"format": "prstore", "version": FORMAT_VERSION,
                        "method": method, "ranges": {}, "shapes": {},
                        "masks": {}, "variables": {}, "segments": {},
                        "blobs": {}}
        manifest["version"] = FORMAT_VERSION
        manifest["journal"] = True
        # the journal exists from birth, so followers always find a file
        # (HTTP followers get an empty 200 rather than a 404)
        open(os.path.join(directory, JOURNAL_NAME), "ab").close()
        _write_atomic(mpath, json.dumps(manifest, sort_keys=True,
                                        indent=1).encode("utf-8"))
        w = cls(directory, manifest, keyframe_interval=keyframe_interval,
                retain_timesteps=retain_timesteps, device=dev)
        w.bytes_written = sum(manifest["blobs"].values())
        return w

    @staticmethod
    def ensure(store_path: str, builder: Callable[[], object],
               shard_by: Optional[str] = None, **kw) -> bool:
        """Create-if-missing, exactly once across racing processes — see
        :func:`ensure_archive`."""
        return ensure_archive(store_path, builder, shard_by=shard_by, **kw)

    # -- journal -------------------------------------------------------------

    def _journal_append(self, records: List[dict]) -> None:
        data = b"".join(json.dumps(r, sort_keys=True).encode("utf-8") + b"\n"
                        for r in records)
        self._jf.write(data)
        self._jf.flush()
        os.fsync(self._jf.fileno())
        self._journal_records += len(records)

    # -- append --------------------------------------------------------------

    def append(self, fields: Dict[str, object], eps: float) -> int:
        """Append one timestep of every supplied variable (numpy arrays or
        tensors) at error bound ``eps``; returns the timestep index
        assigned.  Payload blobs land on disk (publish-by-rename) before
        their journal records, so a reader never learns of a segment whose
        bytes are not all there."""
        if self.sealed:
            raise ValueError("archive is sealed — no further appends")
        if not fields:
            raise ValueError("append needs at least one variable")
        records: List[dict] = []
        t_out = -1
        for name, x in fields.items():
            if "/" in name:
                raise ValueError(f"variable name {name!r} may not "
                                 f"contain '/'")
            x = as_device_tensor(x, self.device)
            shape = tuple(x.shape)
            st = self._vars.get(name)
            if st is None:
                if name in self.manifest["variables"]:
                    raise ValueError(f"variable {name!r} already exists in "
                                     f"the base archive")
                st = _VarState(shape)
                self._vars[name] = st
                rng = float(x.max() - x.min())
                rng = rng if rng > 0 else 1.0
                self.manifest["variables"][name] = {
                    "kind": "timeseries", "base_t": 0, "timesteps": []}
                self.manifest["shapes"][name] = list(shape)
                self.manifest["ranges"][name] = rng
                records.append({"op": "var", "name": name,
                                "kind": "timeseries",
                                "shape": list(shape), "range": rng})
            if shape != st.shape:
                raise ValueError(f"{name}: timestep shape {shape} != "
                                 f"{st.shape}")
            t = st.next_t
            keyframe = st.prev_recon is None \
                or st.since_key >= self.keyframe_interval - 1
            snap, recon = encode_timestep(
                x, eps, None if keyframe else st.prev_recon, self.device)
            blob_name = f"{name}.t{t}.seg"
            payload = b"".join(snap.blobs)
            _write_atomic(os.path.join(self.directory, blob_name), payload)
            off = 0
            for j, b in enumerate(snap.blobs):
                key = f"{name}/t{t}/b{j}"
                crc = crc32c(b)
                self.manifest["segments"][key] = \
                    [blob_name, off, len(b), crc, None]
                records.append({"op": "segment", "key": key,
                                "blob": blob_name, "offset": off,
                                "size": len(b), "crc": crc, "codec": None})
                off += len(b)
            self.manifest["blobs"][blob_name] = off
            self.bytes_written += off
            spec = {"t": t, "keyframe": keyframe, "eps": snap.eps,
                    "orig_shape": list(snap.orig_shape),
                    "padded_shape": list(snap.padded_shape),
                    "levels": snap.levels, "dtypes": list(snap.dtypes),
                    "amax": snap.amax,
                    "blob_sizes": [len(b) for b in snap.blobs]}
            self.manifest["variables"][name]["timesteps"].append(spec)
            records.append(dict(spec, op="timestep", var=name))
            st.prev_recon = recon
            st.next_t = t + 1
            st.since_key = 0 if keyframe else st.since_key + 1
            t_out = t
            if self.retain_timesteps is not None:
                records.extend(self._retain(name, st))
        self._journal_append(records)
        return t_out

    def _retain(self, name: str, st: _VarState) -> List[dict]:
        """Rolling retention: drop the oldest keyframe-aligned prefix once
        the variable exceeds ``retain_timesteps``.  The boundary snaps down
        to a keyframe, so what remains always starts decodable."""
        vspec = self.manifest["variables"][name]
        specs = vspec["timesteps"]
        base_t = vspec["base_t"]
        target = st.next_t - self.retain_timesteps
        idx = target - base_t
        if idx <= 0:
            return []
        while idx > 0 and not specs[idx]["keyframe"]:
            idx -= 1
        if idx <= 0:
            return []
        boundary = base_t + idx
        for spec in specs[:idx]:
            t = spec["t"]
            blob_name = f"{name}.t{t}.seg"
            for j in range(len(spec["blob_sizes"])):
                self.manifest["segments"].pop(f"{name}/t{t}/b{j}", None)
            self.manifest["blobs"].pop(blob_name, None)
            try:
                os.unlink(os.path.join(self.directory, blob_name))
            except OSError:
                pass                    # a racing reader holds it: harmless
        del specs[:idx]
        vspec["base_t"] = boundary
        return [{"op": "retention", "var": name, "base_t": boundary}]

    # -- seal / close --------------------------------------------------------

    def seal(self) -> int:
        """Finalize: append the terminal journal record and atomically
        rewrite ``manifest.json`` as a consolidated, sealed v4 manifest
        folding in every journaled segment and timestep.  Returns the
        payload and manifest bytes on disk."""
        if self.sealed:
            raise ValueError("archive already sealed")
        self._journal_append([{"op": "seal"}])
        self.sealed = True
        self.manifest["sealed"] = True
        self.manifest["journal_records"] = self._journal_records
        mblob = json.dumps(self.manifest, sort_keys=True,
                           indent=1).encode("utf-8")
        _write_atomic(os.path.join(self.directory, MANIFEST_NAME), mblob)
        self.close()
        return sum(self.manifest["blobs"].values()) + len(mblob)

    def close(self) -> None:
        """Release the journal handle without sealing — the archive stays
        live and another writer (or a later run) may keep appending."""
        if not self._jf.closed:
            self._jf.close()

    def __enter__(self) -> "ArchiveWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def ensure_archive(store_path: str, builder: Callable[[], object],
                   shard_by: Optional[str] = None,
                   stale_lock_s: float = 300.0,
                   wait_timeout_s: float = 300.0,
                   poll_s: float = 0.05) -> bool:
    """Create the archive container at ``store_path`` exactly once across
    racing processes; returns True when this call created it.

    Creation is serialized behind ``store_path + ".lock"`` (``O_CREAT |
    O_EXCL``, the portable atomic claim) and published by writing to a
    private ``.tmp.<pid>`` target followed by one atomic ``os.rename``:
    every other process sees no container (and waits on the lock) or the
    complete one, never a prefix.  ``builder`` (returning a port
    ``Archive``) runs only in the winning process.  A lock older than
    ``stale_lock_s`` is presumed crashed and broken; waiters give up with
    ``TimeoutError`` after ``wait_timeout_s``.
    """
    if is_url(store_path) or os.path.exists(store_path):
        return False
    lock_path = store_path + ".lock"
    parent = os.path.dirname(os.path.abspath(store_path))
    os.makedirs(parent, exist_ok=True)
    deadline = time.monotonic() + wait_timeout_s
    while True:
        if os.path.exists(store_path):
            return False                 # someone else finished the job
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(lock_path)
            except OSError:
                continue                 # lock released between EXCL and stat
            if age > stale_lock_s:
                # a crashed creator must not wedge every later start
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out after {wait_timeout_s:.0f}s waiting for "
                    f"{lock_path} (another process creating the archive?)")
            time.sleep(poll_s)
            continue
        try:
            os.write(fd, f"{os.getpid()}\n".encode())
            os.close(fd)
            if os.path.exists(store_path):
                return False             # raced: winner finished before EXCL
            tmp = f"{store_path}.tmp.{os.getpid()}"
            try:
                archive = builder()      # the refactor happens exactly once
                if shard_by:
                    save_sharded_archive(archive, tmp, shard_by=shard_by)
                else:
                    save_archive(archive, tmp)
                os.rename(tmp, store_path)   # publish atomically
            except BaseException:
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
                elif os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            return True
        finally:
            try:
                os.unlink(lock_path)
            except OSError:
                pass
