"""Algorithm 1 (refactor) and the progressive reader for the hb method, on
tensors.

Counterpart of ``repro/core/refactor.py`` for PMGARD-HB (hierarchical-basis
multilevel transform + bitplanes, the paper's preferred method).  The other
representations (ob, ip, psz3, psz3_delta) are later slices of the port.

Where things live: the archive's plane bytes are host data (the entropy
stage is numpy/zlib, as in the reference); the transform, the codec kernels,
the per-level contributions and the reconstruction live on the archive's
device.  The reference brings contributions and reconstructions back to
numpy after every refresh; here they stay on the device and only scalars
cross to the host.

Incremental recomposition (HB linearity)
----------------------------------------
The reconstruction is the fixed-order (coarse -> fine) sum of per-level
contribution fields

    x̂ = Σ_{l = L..0}  recompose_hb_from(scatter(values_l), start=l)

each cached and keyed by the level's fetched-plane count, so a request that
moved the planes of a few levels recomputes only their contributions.  A
contribution is a pure function of its level's decoded values, and decoded
values depend only on plane counts, so any fetch schedule ending at the same
plane counts reconstructs bit-identically — and bit-identically to the JAX
package.

``contrib_budget_bytes`` caps the *retained* contributions at ``budget //
(n·8)`` fields, finest levels first; the rest are computed for the sum and
dropped (spilled), and rebuilt by a later refresh.  The sum is streamed in
the same order, so outputs are bit-identical at any budget.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bitplane.encoder import (
    LevelBitplanes,
    encode_level,
    plane_bound,
    planes_needed,
)
from repro_torch.bitplane.segments import InMemoryPlaneSource, LevelStream
from repro_torch.core.masks import OutlierMask, build_zero_velocity_mask
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.options import SessionOptions
from repro_torch.transform.hierarchical import (
    decompose_hb,
    grid_levels,
    hb_error_bound,
    level_map,
    pad_to_grid,
    scatter_recompose_from,
    unpad,
)

METHODS = ("hb",)
# methods of the reference not ported yet, and the ROADMAP item that ports
# them
_NOT_PORTED = {"ob": "A8", "ip": "A8", "psz3": "A8", "psz3_delta": "A8"}


@dataclass(frozen=True)
class VarAvailability:
    """Availability report for one variable: ``floor`` is the tightest
    L-inf bound it can certify from the segments it can still reach;
    ``pinned`` marks a variable whose segments are partly unavailable (a
    store archive with a missing shard; in-memory archives never are), which
    the retrieval loop must stop tightening.  ``detail`` carries the first
    underlying cause."""
    pinned: bool
    floor: float
    detail: str = ""


@dataclass
class ContribStats:
    """Contribution-cache accounting for one (or more) bitplane readers:
    resident bytes, their high-water mark, spills (computed for a refresh,
    then dropped under the budget) and recomputes (rebuilds of a level whose
    planes had not moved).  All mutation goes through ``contrib_note``
    under one lock, so a shared sink stays consistent."""
    contrib_resident_bytes: int = 0
    contrib_peak_bytes: int = 0
    contrib_spills: int = 0
    contrib_recomputes: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                compare=False)

    def contrib_note(self, delta_bytes: int = 0, spills: int = 0,
                     recomputes: int = 0) -> None:
        with self._mu:
            self.contrib_resident_bytes += delta_bytes
            if self.contrib_resident_bytes > self.contrib_peak_bytes:
                self.contrib_peak_bytes = self.contrib_resident_bytes
            self.contrib_spills += spills
            self.contrib_recomputes += recomputes

    def contrib_snapshot(self) -> Tuple[int, int, int, int]:
        with self._mu:
            return (self.contrib_resident_bytes, self.contrib_peak_bytes,
                    self.contrib_spills, self.contrib_recomputes)

    def merge(self, other: "ContribStats") -> "ContribStats":
        snap = other.contrib_snapshot()
        with self._mu:
            self.contrib_resident_bytes += snap[0]
            self.contrib_peak_bytes += snap[1]
            self.contrib_spills += snap[2]
            self.contrib_recomputes += snap[3]
        return self


# ---------------------------------------------------------------------------
# Archives
# ---------------------------------------------------------------------------


@dataclass
class BitplaneVarArchive:
    """PMGARD-HB: per-level bitplane groups over the multilevel transform."""
    method: str                    # "hb"
    orig_shape: Tuple[int, ...]
    padded_shape: Tuple[int, ...]
    levels: int
    groups: List[LevelBitplanes]   # detail levels 0..L-1, then base (index L)
    group_indices: List[np.ndarray]

    @property
    def total_nbytes(self) -> int:
        return sum(g.total_nbytes for g in self.groups)

    def plane_sources(self) -> List[InMemoryPlaneSource]:
        return [InMemoryPlaneSource(g) for g in self.groups]

    def open_reader(self, options: SessionOptions,
                    device: torch.device) -> "_BitplaneVarReader":
        return _BitplaneVarReader(
            self, device, contrib_budget_bytes=options.contrib_budget_bytes)


@dataclass
class Archive:
    """Refactored multi-precision segments + metadata for all variables;
    sessions opened on it decode on ``device``."""
    method: str
    variables: Dict[str, BitplaneVarArchive]
    masks: Dict[str, OutlierMask]
    ranges: Dict[str, float]
    shapes: Dict[str, Tuple[int, ...]]
    device: torch.device

    @property
    def total_nbytes(self) -> int:
        n = sum(v.total_nbytes for v in self.variables.values())
        n += sum(m.nbytes for m in self.masks.values())
        return n

    def open(self, options: Optional[SessionOptions] = None
             ) -> "RetrievalSession":
        return RetrievalSession(self, options)

    def n_elements(self, name: str) -> int:
        return int(np.prod(self.shapes[name]))


def refactor_variables(fields: Dict[str, np.ndarray],
                       method: str = "hb",
                       nbits: int = 48,
                       max_levels: int = 32,
                       mask_zero_velocity: bool = True,
                       device: DeviceLike = None) -> Archive:
    """Algorithm 1: refactor numpy fields into a progressive archive.  The
    transform and the codec kernels run on ``device`` (default CUDA; raises
    without it unless ``device="cpu"``)."""
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported to repro_torch yet "
            f"(ROADMAP {_NOT_PORTED[method]})")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS + tuple(_NOT_PORTED)}")
    dev = resolve_device(device)
    masks = build_zero_velocity_mask(fields) if mask_zero_velocity else {}
    variables: Dict[str, BitplaneVarArchive] = {}
    ranges: Dict[str, float] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, data in fields.items():
        data = np.asarray(data, dtype=np.float64)
        shapes[name] = data.shape
        rng = float(np.max(data) - np.min(data))
        ranges[name] = rng if rng > 0 else 1.0
        variables[name] = _build_bitplane_var(data, nbits, max_levels, dev)
    return Archive(method=method, variables=variables, masks=masks,
                   ranges=ranges, shapes=shapes, device=dev)


def _build_bitplane_var(data: np.ndarray, nbits: int, max_levels: int,
                        device: torch.device) -> BitplaneVarArchive:
    padded, orig_shape = pad_to_grid(data)
    levels = grid_levels(padded.shape, max_levels)
    coeffs = decompose_hb(torch.from_numpy(padded).to(device), levels)
    flat = coeffs.reshape(-1)
    lmap = level_map(padded.shape, levels).ravel()
    groups, indices = [], []
    for l in range(levels + 1):      # details 0..L-1, base = L
        idx = np.flatnonzero(lmap == l)
        groups.append(encode_level(flat[torch.from_numpy(idx).to(device)],
                                   nbits=nbits))
        indices.append(idx)
    return BitplaneVarArchive(method="hb", orig_shape=orig_shape,
                              padded_shape=padded.shape, levels=levels,
                              groups=groups, group_indices=indices)


# ---------------------------------------------------------------------------
# Progressive reader and retrieval session
# ---------------------------------------------------------------------------


class _BitplaneVarReader:
    """Progressive reader over one hb variable, decoding on ``device``: an
    in-memory `BitplaneVarArchive` or a store-backed
    `repro_torch.store.StoreBitplaneVar` (same surface: shapes, levels,
    groups, group_indices, plane_sources); planes arrive through each
    group's PlaneSource.

    ``contrib_budget_bytes`` bounds the retained contribution cache (see
    module docstring): None keeps every level resident; any other value
    keeps the ``budget // field_nbytes`` finest levels and spills the rest —
    bit-identical outputs at any budget, including zero.  ``contrib_stats``
    is an optional external sink for the ``contrib_*`` counters (store-backed
    readers pass their fetcher's FetchStats, so one object reports transport
    and residency)."""

    def __init__(self, var, device: torch.device,
                 contrib_budget_bytes: Optional[int] = None,
                 contrib_stats=None):
        self.var = var
        self.device = device
        self.streams = [LevelStream(src, device)
                        for src in var.plane_sources()]
        self._idx_dev: Dict[int, torch.Tensor] = {}
        self._recon: Optional[torch.Tensor] = None
        # one cached contribution field per coefficient group, keyed by the
        # fetched-plane count it was computed at (-1 = never computed)
        ngroups = var.levels + 1
        self._contribs: List[Optional[torch.Tensor]] = [None] * ngroups
        self._contrib_fetched: List[int] = [-1] * ngroups
        self._field_nbytes = int(np.prod(var.padded_shape)) * 8
        self.contrib_stats = contrib_stats if contrib_stats is not None \
            else ContribStats()
        if contrib_budget_bytes is None:
            self._resident_cap = ngroups
        else:
            self._resident_cap = min(
                ngroups, max(0, int(contrib_budget_bytes)) //
                self._field_nbytes)

    @property
    def contrib_resident_levels(self) -> List[int]:
        """Levels whose contribution field is currently retained."""
        return [l for l, c in enumerate(self._contribs) if c is not None]

    def _note_resident(self, delta_fields: int) -> None:
        self.contrib_stats.contrib_note(
            delta_bytes=delta_fields * self._field_nbytes)

    @property
    def bytes_fetched(self) -> int:
        return sum(s.bytes_fetched for s in self.streams)

    def _budgets(self, eps: float) -> List[float]:
        """Split the variable's L-inf budget across coefficient groups so
        the HB bound Σ_l e_l meets eps, size-weighted (e_l ∝ n_l minimises
        the total plane bits)."""
        counts = np.asarray([g.count for g in self.var.groups], dtype=float)
        weights = counts / counts.sum()
        return [eps * w for w in weights]

    def _plane_targets(self, eps: float) -> List[int]:
        """Per-group plane targets for a request at ``eps`` — a pure
        function of (eps, static group metadata), never of fetch state."""
        return [planes_needed(s.meta, b)
                for s, b in zip(self.streams, self._budgets(eps))]

    def achieved_bound(self) -> float:
        return hb_error_bound([s.bound for s in self.streams])

    @property
    def is_degraded(self) -> bool:
        """True once any coefficient group pinned at a partial plane prefix
        (a segment of it is permanently unavailable this session)."""
        return any(s.pinned is not None for s in self.streams)

    def availability_floor(self) -> float:
        """Tightest bound certifiable from the deliverable plane prefixes:
        each group contributes its bound at the deepest reachable plane
        (the pin for degraded groups, full depth otherwise), summed like
        ``achieved_bound``."""
        return hb_error_bound([
            plane_bound(s.meta, s.meta.nbits if s.pinned is None
                        else s.pinned) for s in self.streams])

    def availability(self) -> VarAvailability:
        detail = ""
        if self.is_degraded:
            errs = [s.pin_error for s in self.streams
                    if s.pin_error is not None]
            detail = str(errs[0]) if errs else ""
        return VarAvailability(pinned=self.is_degraded,
                               floor=self.availability_floor(),
                               detail=detail)

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        for s, k in zip(self.streams, self._plane_targets(eps)):
            s.fetch_to_planes(k)
        self._refresh_hb_incremental()
        return self._recon, self.achieved_bound()

    def prefetch_eps(self, eps: float, certain: bool = True) -> None:
        """Hint that a request at ``eps`` is coming: split the budget exactly
        as ``request`` will and forward per-group plane ranges to the
        sources (store-backed ones start background fetches; in-memory ones
        ignore it).  No decode state or byte accounting changes."""
        for s, k in zip(self.streams, self._plane_targets(eps)):
            s.prefetch_to_planes(k, certain=certain)

    def _group_idx_dev(self, l: int) -> torch.Tensor:
        idx = self._idx_dev.get(l)
        if idx is None:
            idx = self._idx_dev[l] = torch.from_numpy(
                self.var.group_indices[l]).to(self.device)
        return idx

    def _compute_contrib(self, l: int) -> torch.Tensor:
        """Contribution of group ``l``: its decoded values scattered onto
        the padded grid, partially recomposed from its own level down (a
        group with no planes contributes zeros)."""
        shape, levels = self.var.padded_shape, self.var.levels
        s = self.streams[l]
        if s.fetched == 0:
            return torch.zeros(shape, dtype=F64, device=self.device)
        return scatter_recompose_from(self._group_idx_dev(l), s.values(),
                                      shape, levels, min(l, levels - 1))

    def _refresh_hb_incremental(self) -> None:
        """Recompute only the contributions whose plane counts moved, then
        re-sum in the fixed coarse -> fine order, streaming: each field is
        added, then retained only if its level is among the finest
        ``_resident_cap``."""
        levels = self.var.levels
        stale = [self._contrib_fetched[l] != self.streams[l].fetched
                 for l in range(levels + 1)]
        # the early-out keys on plane counts, not residency: a repeat
        # request at a satisfied eps serves the cached reconstruction even
        # at budget 0
        if not any(stale) and self._recon is not None:
            return
        st = self.contrib_stats
        # launch every stream's deferred decode before adopting any result
        flushes = [(s, s.flush_submit()) for s in self.streams]
        for s, t in flushes:
            s.flush_collect(t)
        total = torch.zeros(self.var.padded_shape, dtype=F64,
                            device=self.device)
        for l in range(levels, -1, -1):       # fixed summation order
            c = self._contribs[l]
            if c is None or stale[l]:
                if c is None and not stale[l]:
                    # planes did not move — an unbounded reader would have
                    # this field cached; the rebuild is pure budget cost
                    st.contrib_note(recomputes=1)
                c = self._compute_contrib(l)
                self._contrib_fetched[l] = self.streams[l].fetched
            total += c
            if l < self._resident_cap:
                if self._contribs[l] is None:
                    self._note_resident(+1)
                self._contribs[l] = c
            else:
                st.contrib_note(spills=1)
        self._recon = unpad(total, self.var.orig_shape)

    def state_signature(self) -> Tuple[int, ...]:
        """Decode state as the tuple of per-group fetched-plane counts; the
        reconstruction is a pure function of it."""
        return tuple(s.fetched for s in self.streams)


class RetrievalSession:
    """Progressive, stateful reader over all variables of an archive — the
    in-memory `Archive` or a store-backed `repro_torch.store.StoreArchive`
    — decoding on the archive's device."""

    def __init__(self, archive,
                 options: Optional[SessionOptions] = None):
        self.archive = archive
        self.options = options if options is not None else SessionOptions()
        self.device = archive.device
        self.readers: Dict[str, _BitplaneVarReader] = {
            name: var.open_reader(self.options, archive.device)
            for name, var in archive.variables.items()}
        self._mask_charged: Dict[str, bool] = {n: False for n in self.readers}
        self._mask_bytes = 0

    @property
    def bytes_retrieved(self) -> int:
        return sum(r.bytes_fetched for r in self.readers.values()) \
            + self._mask_bytes

    def contrib_stats(self) -> ContribStats:
        """Aggregate contribution-cache counters over this session's
        readers.  Distinct sinks are summed once: store-backed readers all
        share their fetcher's FetchStats (which also carries the other
        sessions of the same archive)."""
        agg = ContribStats()
        seen = set()
        for r in self.readers.values():
            if id(r.contrib_stats) not in seen:
                seen.add(id(r.contrib_stats))
                agg.merge(r.contrib_stats)
        return agg

    def availability(self) -> Dict[str, VarAvailability]:
        """Per-variable reports of pinned variables (empty when healthy)."""
        out = {}
        for name, r in self.readers.items():
            a = r.availability()
            if a.pinned:
                out[name] = a
        return out

    @property
    def degraded(self) -> bool:
        return bool(self.availability())

    def prefetch(self, name: str, eps: float, certain: bool = True) -> None:
        """Non-binding hint that ``reconstruct(name, eps)`` is coming: a
        store-backed reader starts moving the planes in the background; for
        an in-memory archive, whose planes are all resident, it does
        nothing."""
        self.readers[name].prefetch_eps(eps, certain=certain)

    def reconstruct(self, name: str, eps: float) -> Tuple[torch.Tensor,
                                                          float]:
        """Reconstruct a variable to L-inf bound <= eps; returns the data on
        the device (outlier-masked points exact) and the achieved bound."""
        data, achieved = self.readers[name].request(eps)
        mask = self.archive.masks.get(name)
        if mask is not None:
            if not self._mask_charged[name]:
                self._mask_bytes += mask.nbytes
                self._mask_charged[name] = True
            data = mask.apply(data)
        return data, achieved

    def eb_array(self, name: str, achieved: float) -> torch.Tensor:
        """Per-point error-bound tensor: achieved everywhere, 0 at exact
        (masked) points."""
        eb = torch.full(self.archive.shapes[name], achieved, dtype=F64,
                        device=self.device)
        mask = self.archive.masks.get(name)
        if mask is not None:
            eb[mask.on(self.device)[0]] = 0.0
        return eb

    def bitrate(self, names: Optional[Sequence[str]] = None) -> float:
        """Bits per element over the referenced variables (paper §III-C)."""
        names = list(names) if names is not None else list(self.readers)
        n_elems = sum(self.archive.n_elements(n) for n in names)
        rbytes = sum(self.readers[n].bytes_fetched for n in names) \
            + self._mask_bytes
        return 8.0 * rbytes / max(n_elems, 1)
