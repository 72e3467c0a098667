"""Snapshot-based progressive schemes (paper §V-B categories 1 and 2), on
tensors.

Counterpart of ``repro/compressors/snapshots.py``.

SnapshotArchive (PSZ3): the data compressed independently at a ladder of
error bounds ε_1 > ε_2 > ...  A request for ε* fetches the smallest snapshot
with ε_i <= ε*; under *progressive* request sequences every newly-needed
snapshot is fetched in full — the cross-snapshot redundancy the paper
penalises in Figs 2/7/8.

DeltaSnapshotArchive (PSZ3-delta, after Magri & Lindstrom): snapshot i
compresses the *residual* against the reconstruction from snapshots < i, so
a request for ε* fetches all first i snapshots but shares bytes across
requests.  decoded_i = Σ_{j<=i} decode_j, with |x - decoded_i|_inf <= ε_i.

Timestep deltas (live archives, manifest v4): ``encode_timestep`` /
``decode_timestep`` apply the same residual idea along the time axis.  A
keyframe compresses the field on its own; a delta timestep compresses
x_k − rec_{k−1} against the previous timestep's *reconstruction*, so the
per-timestep bound is ε_k plus float accumulation slack, whatever the
chain's length.

Snapshot bytes are host data; builds and readers decode on a device, and a
reader's results are tensors there.  A reader never changes a tensor it has
returned: the delta reader's running sum is a new tensor per rung.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compressors.szlike import SZCompressed, as_device_tensor, \
    sz_compress, sz_decompress
from repro_torch.device import DeviceLike, resolve_device


def default_snapshot_eps(value_range: float, n: int = 10,
                         base: float = 10.0) -> List[float]:
    """Paper's ladder: ε_i = range · base^{-i}, i = 1..n."""
    return [value_range * base ** (-(i + 1)) for i in range(n)]


def select_snapshot(snapshots: Sequence, eps: float) -> int:
    """Index of the coarsest snapshot with eps_i <= eps (the ladder is
    sorted loosest-first); the tightest available if none reaches eps."""
    for i, s in enumerate(snapshots):
        if s.eps <= eps:
            return i
    return len(snapshots) - 1


def encode_timestep(x, eps: float, prev_recon: Optional[torch.Tensor] = None,
                    device: DeviceLike = None
                    ) -> Tuple[SZCompressed, torch.Tensor]:
    """Encode one appended timestep on ``device``; returns ``(snap,
    recon)``.

    With ``prev_recon=None`` this is a keyframe, the field compressed on its
    own.  Otherwise the residual ``x - prev_recon`` is compressed, and
    ``recon = prev_recon + decode(snap)``, so ``|x - recon|_inf <= eps``
    holds without compounding along the chain.  ``recon`` is the writer's
    state for the next delta, bit for bit what a reader decodes for this
    timestep; it stays on ``device``.  The subtraction and the addition are
    one rounding each, as in the reference."""
    dev = resolve_device(device)
    x = as_device_tensor(x, dev)
    if prev_recon is None:
        snap = sz_compress(x, eps, device=dev)
        return snap, sz_decompress(snap, dev)
    snap = sz_compress(x - prev_recon, eps, device=dev)
    return snap, prev_recon + sz_decompress(snap, dev)


def decode_timestep(snap: SZCompressed,
                    prev_recon: Optional[torch.Tensor] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Decode one timestep on ``device``: a keyframe stands alone, a delta
    adds onto its chain predecessor's reconstruction."""
    delta = sz_decompress(snap, resolve_device(device))
    return delta if prev_recon is None else prev_recon + delta


def timestep_bound(eps: float, amax_chain: Sequence[float]) -> float:
    """Certified L-inf bound of a timestep decoded through a keyframe→delta
    chain: its own eps plus one rounding allowance per chain link, as
    ``DeltaSnapshotReader.achieved_bound``."""
    amax = max(amax_chain) if len(amax_chain) else 0.0
    return eps + 8 * np.finfo(np.float64).eps * amax * len(amax_chain)


@dataclass
class SnapshotArchive:
    """PSZ3: independent snapshots at decreasing error bounds."""
    snapshots: List[SZCompressed]          # eps strictly decreasing

    @classmethod
    def build(cls, x, eps_ladder: Sequence[float],
              device: DeviceLike = None) -> "SnapshotArchive":
        dev = resolve_device(device)
        x = as_device_tensor(x, dev)
        eps_sorted = sorted(set(float(e) for e in eps_ladder), reverse=True)
        return cls(snapshots=[sz_compress(x, e, device=dev)
                              for e in eps_sorted])

    @property
    def total_nbytes(self) -> int:
        return sum(s.nbytes for s in self.snapshots)

    def open(self, device: DeviceLike = None) -> "SnapshotReader":
        return SnapshotReader(self, resolve_device(device))


class SnapshotReader:
    def __init__(self, archive, device: torch.device):
        self.archive = archive
        self.device = device
        self.fetched = [False] * len(archive.snapshots)
        self.bytes_fetched = 0
        self._cache: Optional[Tuple[int, torch.Tensor]] = None

    def _select(self, eps: float) -> int:
        return select_snapshot(self.archive.snapshots, eps)

    def _decode(self, idx: int) -> torch.Tensor:
        """Decode snapshot ``idx`` — overridden by store-backed readers that
        must fetch the blobs (checksum-verified) before decompressing."""
        return sz_decompress(self.archive.snapshots[idx], self.device)

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        snaps = self.archive.snapshots
        idx = self._select(eps)
        # never go backwards: reuse an already-fetched tighter snapshot
        if self._cache is not None and self._cache[0] >= idx:
            idx = self._cache[0]
        # decode BEFORE charging bytes: a store-backed _decode may fail, and
        # a failed fetch must not leave the snapshot marked fetched/charged
        if self._cache is None or self._cache[0] != idx:
            self._cache = (idx, self._decode(idx))
        if not self.fetched[idx]:
            self.bytes_fetched += snaps[idx].nbytes
            self.fetched[idx] = True
        return self._cache[1], snaps[idx].safe_eps


@dataclass
class DeltaSnapshotArchive:
    """PSZ3-delta: residual ladder; request(ε) needs all snapshots with
    ε_j >= smallest satisfying ε_i."""
    snapshots: List[SZCompressed]
    eps_ladder: List[float]

    @classmethod
    def build(cls, x, eps_ladder: Sequence[float],
              device: DeviceLike = None) -> "DeltaSnapshotArchive":
        dev = resolve_device(device)
        eps_sorted = sorted(set(float(e) for e in eps_ladder), reverse=True)
        x = as_device_tensor(x, dev)
        snaps: List[SZCompressed] = []
        decoded = torch.zeros_like(x)
        for e in eps_sorted:
            snap = sz_compress(x - decoded, e, device=dev)
            snaps.append(snap)
            decoded = decoded + sz_decompress(snap, dev)
        return cls(snapshots=snaps, eps_ladder=eps_sorted)

    @property
    def total_nbytes(self) -> int:
        return sum(s.nbytes for s in self.snapshots)

    def open(self, device: DeviceLike = None) -> "DeltaSnapshotReader":
        return DeltaSnapshotReader(self, resolve_device(device))


class DeltaSnapshotReader:
    def __init__(self, archive, device: torch.device):
        self.archive = archive
        self.device = device
        self.n_fetched = 0
        self.bytes_fetched = 0
        self._decoded: Optional[torch.Tensor] = None

    def _select(self, eps: float) -> int:
        return select_snapshot(self.archive.snapshots, eps)

    def _decode(self, idx: int) -> torch.Tensor:
        return sz_decompress(self.archive.snapshots[idx], self.device)

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        snaps = self.archive.snapshots
        idx = self._select(eps)
        while self.n_fetched <= idx:
            snap = snaps[self.n_fetched]
            # decode BEFORE charging: a store-backed _decode may fail, and a
            # failed rung must not be charged or counted as applied
            delta = self._decode(self.n_fetched)
            self.bytes_fetched += snap.nbytes
            # a new tensor: the previous rung's sum may be held by a caller
            self._decoded = delta if self._decoded is None \
                else self._decoded + delta
            self.n_fetched += 1
        return self._decoded, self.achieved_bound()

    def achieved_bound(self) -> float:
        """Bound certified by the rungs applied so far: tightest applied
        snapshot's eps + accumulation rounding slack."""
        base = self.archive.snapshots[self.n_fetched - 1]
        slack = 8 * np.finfo(np.float64).eps * base.amax * self.n_fetched
        return base.eps + slack
