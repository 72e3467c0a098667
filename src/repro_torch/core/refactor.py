"""Algorithm 1 (refactor) and the progressive readers, on tensors.

Counterpart of ``repro/core/refactor.py`` for its five representations,
three bitplane ones:

  * "hb"  PMGARD-HB: hierarchical-basis multilevel + bitplanes (the paper's
          preferred method — tight Σ_l e_l bound);
  * "ob"  PMGARD (orthogonal basis): + L² projection, loose bound, levels
          coupled, so the reader recomposes from scratch;
  * "ip"  interpolation-predicted: closed-loop residuals against the
          decoder's truncated reconstruction; max_g e_g bound once every
          group reaches its recorded prediction depth
          (``transform/hierarchical.py``, ip section).

and the SZ-like snapshot ladders of the paper's comparison (§V-B):

  * "psz3"        independent snapshots at a ladder of bounds;
  * "psz3_delta"  a residual ladder, each rung coding what the looser
                  rungs left (``compressors/snapshots.py``).

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
the same order, so outputs are bit-identical at any budget.  A server-wide
``contrib_pool`` (``repro_torch.serve.budget``) replaces the static cap:
retention becomes a lease against one pool shared by every session, and
the serve plane's hooks (``state_signature``, ``advance_to``,
``adopt_reconstruction``, ``close``) let concurrent sessions coalesce
duplicate requests (``repro_torch.serve.coalesce``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bitplane.encoder import (
    LevelBitplanes,
    decode_prefix,
    encode_level,
    plane_bound,
    planes_needed,
)
from repro_torch.bitplane.segments import InMemoryPlaneSource, LevelStream
from repro_torch.compressors.snapshots import (
    DeltaSnapshotArchive,
    SnapshotArchive,
    default_snapshot_eps,
)
from repro_torch.core.masks import OutlierMask, build_zero_velocity_mask
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.options import SessionOptions, _from_legacy
from repro_torch.transform.hierarchical import (
    decompose_hb,
    grid_levels,
    hb_error_bound,
    ip_error_bound,
    level_map,
    pad_to_grid,
    recompose_hb,
    scatter_recompose_from,
    scatter_recompose_ip_from,
    unpad,
)
from repro_torch.transform.orthogonal import (
    decompose_ob,
    ob_kappa,
    recompose_ob,
)

METHODS = ("hb", "ob", "ip", "psz3", "psz3_delta")
BITPLANE_METHODS = ("hb", "ob", "ip")


def _pred_planes(meta) -> int:
    """Recorded ip prediction depth of a group; groups without one (hb and
    ob groups) default to full depth, where the truncation is the
    identity."""
    return meta.pred_planes if meta.pred_planes is not None else meta.nbits


def _resolve_session_options(options: Optional[SessionOptions],
                             legacy: dict, where: str) -> SessionOptions:
    """Shared shim: an explicit SessionOptions wins; loose legacy kwargs
    build one through the once-warning deprecation path; neither means the
    defaults.  Mixing the two spellings is an error: merging them would
    make the options object lie about what the session uses."""
    if legacy:
        if options is not None:
            raise TypeError(f"{where}: pass either a SessionOptions object "
                            f"or legacy keyword arguments, not both")
        return _from_legacy(SessionOptions, legacy, where)
    return options if options is not None else SessionOptions()


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
    """Per-level bitplane groups over the multilevel transform."""
    method: str                    # "hb" | "ob" | "ip"
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

    def open_reader(self, options: Optional[SessionOptions] = None,
                    device: DeviceLike = None,
                    **legacy) -> "_BitplaneVarReader":
        opts = _resolve_session_options(options, legacy,
                                        "BitplaneVarArchive.open_reader")
        return _BitplaneVarReader(
            self, resolve_device(device),
            contrib_budget_bytes=opts.contrib_budget_bytes,
            contrib_pool=opts.contrib_pool,
            decode_batcher=opts.decode_batcher)


@dataclass
class SnapshotVarArchive:
    """psz3 / psz3_delta variable: a snapshot ladder of host bytes."""
    archive: object                # SnapshotArchive | DeltaSnapshotArchive

    @property
    def total_nbytes(self) -> int:
        return self.archive.total_nbytes

    def open_reader(self, options: Optional[SessionOptions] = None,
                    device: DeviceLike = None,
                    **legacy) -> "_SnapshotVarReader":
        # snapshot readers hold at most one decoded field; the contribution
        # budget/pool is a bitplane-reader concept and is accepted (and
        # validated) for interface uniformity only
        _resolve_session_options(options, legacy,
                                 "SnapshotVarArchive.open_reader")
        return _SnapshotVarReader(self, resolve_device(device))


@dataclass
class Archive:
    """Refactored multi-precision segments + metadata for all variables;
    sessions opened on it decode on ``device``."""
    method: str
    variables: Dict[str, object]
    masks: Dict[str, OutlierMask]
    ranges: Dict[str, float]
    shapes: Dict[str, Tuple[int, ...]]
    device: torch.device

    @property
    def total_nbytes(self) -> int:
        n = sum(v.total_nbytes for v in self.variables.values())
        n += sum(m.nbytes for m in self.masks.values())
        return n

    def open(self, options: Optional[SessionOptions] = None,
             **legacy) -> "RetrievalSession":
        opts = _resolve_session_options(options, legacy, "Archive.open")
        return RetrievalSession(self, opts)

    def n_elements(self, name: str) -> int:
        return int(np.prod(self.shapes[name]))


def refactor_variables(fields: Dict[str, np.ndarray],
                       method: str = "hb",
                       nbits: int = 48,
                       max_levels: int = 32,
                       snapshot_eps: Optional[Sequence[float]] = None,
                       n_snapshots: int = 10,
                       mask_zero_velocity: bool = True,
                       device: DeviceLike = None) -> Archive:
    """Algorithm 1: refactor numpy fields into a progressive archive.  The
    transform, the codec kernels and the snapshot compressors' prediction
    loop run on ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).  The snapshot methods take the ladder
    ``snapshot_eps``, by default ``n_snapshots`` rungs range · 10^-i."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    dev = resolve_device(device)
    masks = build_zero_velocity_mask(fields) if mask_zero_velocity else {}
    variables: Dict[str, object] = {}
    ranges: Dict[str, float] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, data in fields.items():
        data = np.asarray(data, dtype=np.float64)
        shapes[name] = data.shape
        rng = float(np.max(data) - np.min(data))
        ranges[name] = rng if rng > 0 else 1.0
        if method in BITPLANE_METHODS:
            variables[name] = _build_bitplane_var(data, method, nbits,
                                                  max_levels, dev)
            continue
        ladder = list(snapshot_eps) if snapshot_eps is not None else \
            default_snapshot_eps(ranges[name], n=n_snapshots)
        build = SnapshotArchive.build if method == "psz3" \
            else DeltaSnapshotArchive.build
        variables[name] = SnapshotVarArchive(build(data, ladder, device=dev))
    return Archive(method=method, variables=variables, masks=masks,
                   ranges=ranges, shapes=shapes, device=dev)


def _build_bitplane_var(data: np.ndarray, method: str, nbits: int,
                        max_levels: int,
                        device: torch.device) -> BitplaneVarArchive:
    padded, orig_shape = pad_to_grid(data)
    levels = grid_levels(padded.shape, max_levels)
    x = torch.from_numpy(padded).to(device)
    if method == "ip":
        groups, indices = _encode_ip_groups(x, levels, nbits)
    else:
        transform = decompose_hb if method == "hb" else decompose_ob
        flat = transform(x, levels).reshape(-1)
        lmap = level_map(padded.shape, levels).ravel()
        groups, indices = [], []
        for l in range(levels + 1):      # details 0..L-1, base = L
            idx = np.flatnonzero(lmap == l)
            groups.append(encode_level(
                flat[torch.from_numpy(idx).to(device)], nbits=nbits))
            indices.append(idx)
    return BitplaneVarArchive(method=method, orig_shape=orig_shape,
                              padded_shape=padded.shape, levels=levels,
                              groups=groups, group_indices=indices)


def _encode_ip_groups(x: torch.Tensor, levels: int, nbits: int
                      ) -> Tuple[List[LevelBitplanes], List[np.ndarray]]:
    """Closed-loop interpolation-predicted encoding (method "ip") of the
    padded field ``x``, on its device.

    Groups are encoded base-first: each group's coefficients are the
    residual of the original nodal values against the running sum of the
    coarser groups' *decoder* contributions — the same prefix decode, the
    same truncated scatter + recompose and the same float64 accumulation
    order that the reader replays — so once every group is fetched to its
    recorded ``pred_planes`` the decoder's prediction is the encoder's, bit
    for bit, and the bound is max_g e_g.

    ``pred_planes`` comes from one absolute truncation target θ =
    amax_min / (2·(levels+1)) (amax_min: the smallest nonzero per-group hb
    surplus scale): kp = ceil(E_g - log2 θ)."""
    shape, dev = tuple(x.shape), x.device
    lmap = level_map(shape, levels).ravel()
    indices = [np.flatnonzero(lmap == l) for l in range(levels + 1)]
    idx_dev = [torch.from_numpy(i).to(dev) for i in indices]
    hb = decompose_hb(x, levels).reshape(-1)
    amaxes = [float(hb[i].abs().max()) if i.numel() else 0.0
              for i in idx_dev]
    nonzero = [a for a in amaxes if a > 0.0]
    theta = min(nonzero) / (2.0 * (levels + 1)) if nonzero else 0.0
    x_flat = x.reshape(-1)
    total = torch.zeros(shape, dtype=F64, device=dev)
    groups: List[LevelBitplanes] = [None] * (levels + 1)
    for l in range(levels, -1, -1):      # base first — prediction order
        idx = idx_dev[l]
        lbp = encode_level(x_flat[idx] - total.reshape(-1)[idx],
                           nbits=nbits)
        if lbp.exponent is not None:
            kp = nbits
            if theta > 0.0:
                kp = int(np.clip(int(np.ceil(lbp.exponent - np.log2(theta))),
                                 0, nbits))
            lbp.pred_planes = kp
            if l > 0 and kp > 0:
                total += scatter_recompose_ip_from(
                    idx, decode_prefix(lbp, kp, dev), shape, levels,
                    min(l, levels - 1), 2.0 ** (lbp.exponent - kp))
        groups[l] = lbp
    return groups, indices


# ---------------------------------------------------------------------------
# Progressive reader and retrieval session
# ---------------------------------------------------------------------------


class _BitplaneVarReader:
    """Progressive reader over one bitplane variable, decoding on ``device``: an
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
    and residency).

    ``contrib_pool`` replaces the static cap with a server-wide
    ``ContribBudgetPool``: retention becomes a borrow against one shared
    pool (hottest variables win), and slot mutation moves under the pool's
    lock so cross-session reclaim is race-free; outputs stay bit-identical.
    ``decode_batcher`` routes the streams' decodes and the contribution
    rebuilds through a shared ``DecodeBatcher``."""

    def __init__(self, var, device: torch.device,
                 contrib_budget_bytes: Optional[int] = None,
                 contrib_stats=None, contrib_pool=None, decode_batcher=None):
        self.var = var
        self.device = device
        self._batcher = decode_batcher
        self.streams = [LevelStream(src, device, batcher=decode_batcher)
                        for src in var.plane_sources()]
        self._idx_dev: Dict[int, torch.Tensor] = {}
        self._recon: Optional[torch.Tensor] = None
        self._full_state: Tuple[int, ...] = ()
        # one cached contribution field per coefficient group, keyed by the
        # fetched-plane count it was computed at (-1 = never computed)
        ngroups = var.levels + 1
        self._contribs: List[Optional[torch.Tensor]] = [None] * ngroups
        self._contrib_fetched: List[int] = [-1] * ngroups
        self._field_nbytes = int(np.prod(var.padded_shape)) * 8
        self.contrib_stats = contrib_stats if contrib_stats is not None \
            else ContribStats()
        self._pool = contrib_pool
        if contrib_pool is not None or contrib_budget_bytes is None:
            # unbounded, or the pool arbitrates dynamically
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

    def _pool_set_contrib(self, slot: int, value) -> None:
        """Slot mutation for pooled readers — called only by the pool,
        under its lock (deposit on retain, clear on reclaim or release), so
        a refresh on one session and a reclaim driven by another never
        interleave half-way.  Residency accounting moves with the slot."""
        had = self._contribs[slot] is not None
        self._contribs[slot] = value
        has = value is not None
        if has and not had:
            self._note_resident(+1)
        elif had and not has:
            self._note_resident(-1)

    @property
    def bytes_fetched(self) -> int:
        return sum(s.bytes_fetched for s in self.streams)

    def _budgets(self, eps: float) -> List[float]:
        """Split the variable's L-inf budget across coefficient groups so
        the method's composition bound meets eps, size-weighted (e_l ∝ n_l
        minimises the total plane bits); ob divides the detail budgets by
        (1 + κ), as its bound amplifies them."""
        counts = np.asarray([g.count for g in self.var.groups], dtype=float)
        weights = counts / counts.sum()
        if self.var.method in ("hb", "ip"):
            return [eps * w for w in weights]
        kappa = ob_kappa(len(self.var.padded_shape))
        return [eps * w / (1.0 + kappa) for w in weights[:-1]] \
            + [eps * weights[-1]]

    def _ip_quantum(self, l: int) -> float:
        """Group ``l``'s prediction quantum 2^{E-kp} (0.0 for an all-zero
        group — no truncation)."""
        m = self.streams[l].meta
        if m.exponent is None:
            return 0.0
        return 2.0 ** (m.exponent - _pred_planes(m))

    def _ip_mismatches(self, depths: List[int]) -> List[float]:
        """Per-group prediction mismatch δ_g at the given plane depths (0
        once the depth reaches the recorded ``pred_planes``)."""
        out = []
        for s, k in zip(self.streams, depths):
            m = s.meta
            kp = _pred_planes(m)
            if m.exponent is None or k >= kp:
                out.append(0.0)
            else:
                out.append(2.0 ** (m.exponent - k) - 2.0 ** (m.exponent - kp))
        return out

    def _plane_targets(self, eps: float) -> List[int]:
        """Per-group plane targets for a request at ``eps`` — a pure
        function of (eps, static group metadata), never of fetch state.
        hb/ob: the size-weighted eps split.  ip picks the cheaper, by
        from-zero bytes, of (A) the hb-style split, bound Σ_g e_g, and (B)
        every group to max(pred_planes, planes_needed(eps)), bound
        max_g e_g."""
        metas = [s.meta for s in self.streams]
        ka = [planes_needed(m, b) for m, b in zip(metas, self._budgets(eps))]
        if self.var.method != "ip":
            return ka
        kb = [max(_pred_planes(m), planes_needed(m, eps))
              if m.exponent is not None else 0 for m in metas]

        def cost(ks):
            return sum(sum(m.plane_sizes[:k]) + (m.sign_size if k else 0)
                       for m, k in zip(metas, ks))

        return kb if cost(kb) <= cost(ka) else ka

    def _compose(self, bounds: List[float], depths: List[int]) -> float:
        """The method's L-inf bound from per-group bounds at ``depths``."""
        if self.var.method == "hb":
            return hb_error_bound(bounds)
        if self.var.method == "ip":
            return ip_error_bound(bounds, self._ip_mismatches(depths))
        kappa = ob_kappa(len(self.var.padded_shape))
        return float((1.0 + kappa) * np.sum(bounds[:-1]) + bounds[-1])

    def achieved_bound(self) -> float:
        return self._compose([s.bound for s in self.streams],
                             [s.fetched for s in self.streams])

    @property
    def is_degraded(self) -> bool:
        """True once any coefficient group pinned at a partial plane prefix
        (a segment of it is permanently unavailable this session)."""
        return any(s.pinned is not None for s in self.streams)

    def availability_floor(self) -> float:
        """Tightest bound certifiable from the deliverable plane prefixes:
        each group contributes its bound at the deepest reachable plane
        (the pin for degraded groups, full depth otherwise), composed like
        ``achieved_bound``."""
        depths = [s.meta.nbits if s.pinned is None else s.pinned
                  for s in self.streams]
        return self._compose([plane_bound(s.meta, d)
                              for s, d in zip(self.streams, depths)], depths)

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
        if self.var.method == "ob":
            self._refresh_full()
        else:
            self._refresh_hb_incremental()
        return self._recon, self.achieved_bound()

    def reconstruct_at_resolution(self, coarsen: int, eps: float
                                  ) -> Tuple[torch.Tensor, float]:
        """Progression in resolution (paper §II): reconstruct the
        2^coarsen-strided sub-grid from the coarser groups only — detail
        levels 0..coarsen-1 are never moved.  Returns the coarse field and
        its bound relative to the true coarse-grid values.  hb and ip only:
        ob's projection mixes finer details into coarse nodal values."""
        if self.var.method not in ("hb", "ip"):
            raise ValueError("resolution progression requires method='hb' "
                             "or method='ip'")
        levels = self.var.levels
        coarsen = int(np.clip(coarsen, 0, levels))
        active = list(range(coarsen, levels + 1))   # coarser details + base
        targets = self._plane_targets(eps)
        for l in active:
            self.streams[l].fetch_to_planes(targets[l])
        if self.var.method == "ip":
            # ip is defined by the fixed-order contribution sum
            rec = torch.zeros(self.var.padded_shape, dtype=F64,
                              device=self.device)
            for l in range(levels, coarsen - 1, -1):
                rec += self._compute_contrib(l)
        else:
            flat = torch.zeros(int(np.prod(self.var.padded_shape)),
                               dtype=F64, device=self.device)
            for l in active:
                flat[self._group_idx_dev(l)] = self.streams[l].values()
            rec = recompose_hb(flat.reshape(self.var.padded_shape), levels)
        full = unpad(rec, self.var.orig_shape)
        coarse = full[tuple(slice(None, None, 1 << coarsen)
                            for _ in self.var.orig_shape)]
        # coarse nodes never receive finer-level contributions, so only the
        # active groups' bounds apply
        bounds = [self.streams[l].bound for l in active]
        if self.var.method == "ip":
            mism = self._ip_mismatches([s.fetched for s in self.streams])
            achieved = ip_error_bound(bounds, [mism[l] for l in active])
        else:
            achieved = float(np.sum(bounds))
        return coarse, achieved

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

    def _contrib_submit(self, l: int):
        """Phase 1 of a contribution rebuild: group ``l``'s decoded values
        scattered onto the padded grid and partially recomposed from its own
        level down.  With a shared DecodeBatcher the rebuild is queued there
        (same-shape rebuilds across readers merge into one dispatch);
        without one it is computed when collected, so a refresh holds one
        rebuilt field at a time, as a streamed sum should.  Returns a handle
        for ``_contrib_collect``."""
        if self._batcher is None or self.streams[l].fetched == 0:
            return ("inline", None)
        shape, levels = self.var.padded_shape, self.var.levels
        q = self._ip_quantum(l) if self.var.method == "ip" else None
        return ("ticket", self._batcher.submit_recompose(
            self._group_idx_dev(l), self.streams[l].values(), shape, levels,
            min(l, levels - 1), quantum=q))

    def _contrib_collect(self, l: int, handle) -> torch.Tensor:
        """Phase 2: the contribution field (zeros for a group with no
        planes)."""
        kind, ticket = handle
        if kind == "ticket":
            return ticket.result()
        shape, levels = self.var.padded_shape, self.var.levels
        s = self.streams[l]
        if s.fetched == 0:
            return torch.zeros(shape, dtype=F64, device=self.device)
        start = min(l, levels - 1)       # base group (index L) needs all steps
        if self.var.method == "ip":
            # the truncated part seeds the finer groups' prediction; the
            # tail rides back in at the group's own nodes
            return scatter_recompose_ip_from(self._group_idx_dev(l),
                                             s.values(), shape, levels,
                                             start, self._ip_quantum(l))
        return scatter_recompose_from(self._group_idx_dev(l), s.values(),
                                      shape, levels, start)

    def _compute_contrib(self, l: int) -> torch.Tensor:
        """Contribution of group ``l``: a pure function of its decoded
        values."""
        return self._contrib_collect(l, self._contrib_submit(l))

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
        # phase 1: submit every stream's deferred decode before collecting
        # any, so a shared DecodeBatcher can merge this reader's flushes —
        # and concurrent sessions' — into one launch per word width
        flushes = [(s, s.flush_submit()) for s in self.streams]
        for s, t in flushes:
            s.flush_collect(t)
        # phase 2: the same submit-then-collect for the contribution
        # rebuilds this refresh needs (collected inside the fixed-order sum)
        pending = {l: self._contrib_submit(l) for l in range(levels, -1, -1)
                   if self._contribs[l] is None or stale[l]}
        total = torch.zeros(self.var.padded_shape, dtype=F64,
                            device=self.device)
        for l in range(levels, -1, -1):       # fixed summation order
            c = self._contribs[l]
            # a pooled slot can also be reclaimed after ``pending`` was
            # built, by another session or by this refresh's own retain of
            # a coarser level: rebuild it here, inline
            if l in pending or c is None:
                if c is None and not stale[l]:
                    # planes did not move — an unbounded reader would have
                    # this field cached; the rebuild is pure budget cost
                    st.contrib_note(recomputes=1)
                c = self._contrib_collect(l, pending.get(l, ("inline", None)))
                self._contrib_fetched[l] = self.streams[l].fetched
            total += c
            if self._pool is not None:
                # pooled retention: a field-sized lease against the
                # server-wide pool, deposited into the slot under the pool's
                # lock (colder holdings of any session reclaimed first); a
                # denial spills this field instead
                if not self._pool.retain(self, slot=l, level=l,
                                         nbytes=self._field_nbytes, value=c):
                    st.contrib_note(spills=1)
            elif l < self._resident_cap:
                if self._contribs[l] is None:
                    self._note_resident(+1)
                self._contribs[l] = c
            else:
                st.contrib_note(spills=1)
        self._recon = unpad(total, self.var.orig_shape)

    def _refresh_full(self) -> None:
        """ob: the L² corrections couple levels, so the reconstruction is
        recomposed from scratch whenever any stream moved."""
        state = self.state_signature()
        if self._recon is not None and state == self._full_state:
            return
        flat = torch.zeros(int(np.prod(self.var.padded_shape)), dtype=F64,
                           device=self.device)
        for l, s in enumerate(self.streams):
            flat[self._group_idx_dev(l)] = s.values()
        self._recon = unpad(recompose_ob(flat.reshape(self.var.padded_shape),
                                         self.var.levels),
                            self.var.orig_shape)
        self._full_state = state

    # -- serve-plane hooks (repro_torch.serve.coalesce / budget) ----------

    def state_signature(self) -> Tuple[int, ...]:
        """Decode state as the tuple of per-group fetched-plane counts; the
        reconstruction is a pure function of it, which is what makes
        cross-session coalescing sound: two readers with equal signatures
        reconstruct bit-identically."""
        return tuple(s.fetched for s in self.streams)

    def advance_to(self, eps: float) -> bool:
        """Move every stream exactly as ``request(eps)`` would, without
        recomposing — the coalescer's waiter path (the leader's fetch made
        these planes cache-hot).  Returns True if any stream moved."""
        moved = False
        for s, k in zip(self.streams, self._plane_targets(eps)):
            if s.fetch_to_planes(k):
                moved = True
        return moved

    def adopt_reconstruction(self, recon: torch.Tensor) -> None:
        """Install an externally computed reconstruction for the current
        decode state (coalescing fan-out).  Contribution slots whose plane
        counts moved since they were cached are dropped — a later refresh
        must not serve them; the slots that did not move stay valid."""
        for l in range(self.var.levels + 1):
            if self._contrib_fetched[l] != self.streams[l].fetched:
                if self._contribs[l] is not None:
                    if self._pool is not None:
                        self._pool.release(self, l)   # clears slot + counts
                    else:
                        self._note_resident(-1)
                        self._contribs[l] = None
                self._contrib_fetched[l] = self.streams[l].fetched
        self._recon = recon
        self._full_state = self.state_signature()

    def close(self) -> None:
        """Return pooled leases (the serve plane closes sessions; a reader
        without a pool has nothing to give back)."""
        if self._pool is not None:
            self._pool.release_owner(self)


class _SnapshotVarReader:
    """Progressive reader over one in-memory snapshot variable, decoding on
    ``device``."""

    def __init__(self, var: SnapshotVarArchive, device: torch.device):
        self.reader = var.archive.open(device)

    @property
    def bytes_fetched(self) -> int:
        return self.reader.bytes_fetched

    def request(self, eps: float) -> Tuple[torch.Tensor, float]:
        return self.reader.request(eps)


class RetrievalSession:
    """Progressive, stateful reader over all variables of an archive — the
    in-memory `Archive` or a store-backed `repro_torch.store.StoreArchive`
    — decoding on the archive's device.  Every variable builds its own
    reader; contribution counters, availability and prefetch hints reach
    the readers that have them (bitplane readers, store-backed snapshot
    readers) and skip the others.

    Session policy comes from a :class:`repro_torch.options.SessionOptions`
    (prefetch depth, contribution budget or shared pool, decode batcher);
    the pre-v4 loose kwargs still work through the once-warning
    deprecation shim.  ``coalescer`` (assignable after construction)
    routes ``reconstruct`` through cross-session single-flight."""

    def __init__(self, archive, options: Optional[SessionOptions] = None,
                 **legacy):
        self.archive = archive
        self.options = _resolve_session_options(options, legacy,
                                                "RetrievalSession")
        self.contrib_budget_bytes = self.options.contrib_budget_bytes
        self.contrib_pool = self.options.contrib_pool
        self.coalescer = None
        # how many reassign_eb reduction steps ahead the retrieval loop may
        # hint to the fetcher (depth 1 is always a prefix of the next
        # round's fetch, so nothing speculative is ever wasted)
        self.prefetch_depth = self.options.prefetch_depth
        self.device = archive.device
        self.readers: Dict[str, object] = {
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
        bitplane readers.  Distinct sinks are summed once: store-backed
        readers all share their fetcher's FetchStats (which also carries the
        other sessions of the same archive)."""
        agg = ContribStats()
        seen = set()
        for r in self.readers.values():
            st = getattr(r, "contrib_stats", None)
            if st is not None and id(st) not in seen:
                seen.add(id(st))
                agg.merge(st)
        return agg

    def availability(self) -> Dict[str, VarAvailability]:
        """Per-variable reports of pinned variables (empty when healthy)."""
        out = {}
        for name, r in self.readers.items():
            get = getattr(r, "availability", None)
            if get is not None:
                a = get()
                if a.pinned:
                    out[name] = a
        return out

    @property
    def degraded(self) -> bool:
        return bool(self.availability())

    def reader(self, name: str):
        """The per-variable reader, opened lazily for a variable that
        appeared after this session did (live archives: a journal replay on
        ``refresh()`` can add timeseries variables to an open archive)."""
        r = self.readers.get(name)
        if r is None:
            var = self.archive.variables.get(name)
            if var is None:
                refresh = getattr(self.archive, "refresh", None)
                if refresh is not None:
                    refresh()          # maybe it was journaled since open
                var = self.archive.variables.get(name)
            if var is None:
                raise KeyError(name)
            r = var.open_reader(self.options, self.device)
            self.readers[name] = r
            self._mask_charged.setdefault(name, False)
        return r

    def follow(self, name: str) -> "FollowStream":
        """Follow-mode view over a live timeseries variable: ``poll()``
        surfaces newly appended timesteps (refreshing the archive's journal
        first), ``read(t)`` decodes them — without reopening anything, and
        bit-identical to a one-shot session over the same data."""
        return FollowStream(self, name)

    def prefetch(self, name: str, eps: float, certain: bool = True) -> None:
        """Non-binding hint that ``reconstruct(name, eps)`` is coming: a
        store-backed reader starts moving the segments in the background;
        for an in-memory archive, whose segments are all resident, it does
        nothing.  ``certain=False`` marks a predicted eps, which psz3's
        independent snapshots skip."""
        prefetch = getattr(self.readers.get(name), "prefetch_eps", None)
        if prefetch is not None:
            prefetch(eps, certain=certain)

    def reconstruct(self, name: str, eps: float) -> Tuple[torch.Tensor,
                                                          float]:
        """Reconstruct a variable to L-inf bound <= eps; returns the data on
        the device (outlier-masked points exact) and the achieved bound.
        With a ``coalescer`` attached (serve plane), concurrent duplicate
        requests across sessions collapse into one fetch + recompose —
        bit-identical results by the plane-count invariant."""
        reader = self.reader(name)
        if self.coalescer is not None:
            data, achieved = self.coalescer.reconstruct(self, name, eps)
        else:
            data, achieved = reader.request(eps)
        mask = self.archive.masks.get(name)
        if mask is not None:
            if not self._mask_charged[name]:
                self._mask_bytes += mask.nbytes
                self._mask_charged[name] = True
            data = mask.apply(data)
        return data, achieved

    def reconstruct_at_resolution(self, name: str, coarsen: int, eps: float
                                  ) -> Tuple[torch.Tensor, float]:
        """Progression in resolution (paper §II): the 2^coarsen-strided
        sub-grid with an L-inf guarantee, moving only coarse-level segments
        (hb and ip archives)."""
        reader = self.readers[name]
        if not isinstance(reader, _BitplaneVarReader):
            raise ValueError("resolution progression requires a bitplane "
                             "(hb/ip) archive")
        return reader.reconstruct_at_resolution(coarsen, eps)

    def eb_array(self, name: str, achieved: float) -> torch.Tensor:
        """Per-point error-bound tensor: achieved everywhere, 0 at exact
        (masked) points."""
        eb = torch.full(self.archive.shapes[name], achieved, dtype=F64,
                        device=self.device)
        mask = self.archive.masks.get(name)
        if mask is not None:
            eb[mask.on(self.device)[0]] = 0.0
        return eb

    def close(self) -> None:
        """Release per-reader resources (pooled contribution leases).  The
        serve plane calls this when it retires a sticky session; sessions
        without a pool have nothing to release."""
        for r in self.readers.values():
            close = getattr(r, "close", None)
            if close is not None:
                close()

    def bitrate(self, names: Optional[Sequence[str]] = None) -> float:
        """Bits per element over the referenced variables (paper §III-C)."""
        names = list(names) if names is not None else list(self.readers)
        n_elems = sum(self.archive.n_elements(n) for n in names)
        rbytes = sum(self.readers[n].bytes_fetched for n in names) \
            + self._mask_bytes
        return 8.0 * rbytes / max(n_elems, 1)


class FollowStream:
    """Live view over one timeseries variable of an open session.

    ``poll()`` refreshes the archive's journal and returns the timestep
    indices that became visible since the previous poll (never reporting
    one twice); ``read(t)`` decodes a retained timestep through the
    session's chain-caching reader, so walking the stream in order pays one
    delta decode per step — which keeps a followed session bit- and
    byte-identical to a one-shot session over the same timesteps."""

    def __init__(self, session: RetrievalSession, name: str):
        reader = session.reader(name)
        var = getattr(reader, "var", None)
        if var is None or not hasattr(var, "timesteps"):
            raise ValueError(f"variable {name!r} is not a timeseries — "
                             f"follow() needs a journaled (v4) live archive")
        self.session = session
        self.name = name
        self._reader = reader
        self._var = var
        # report everything already visible on the first poll
        self._next_t = var.base_t

    @property
    def latest(self) -> Optional[int]:
        """Newest visible timestep index (None before the first append)."""
        return self._var.latest_t

    def poll(self) -> List[int]:
        """Refresh the journal; return newly visible timestep indices."""
        refresh = getattr(self.session.archive, "refresh", None)
        if refresh is not None:
            refresh()
        latest = self._var.latest_t
        if latest is None:
            return []
        start = max(self._next_t, self._var.base_t)
        if start > latest:
            return []
        self._next_t = latest + 1
        return list(range(start, latest + 1))

    def read(self, t: int) -> Tuple[torch.Tensor, float]:
        """Decode timestep ``t``; returns ``(data, certified bound)`` with
        the data on the session's device."""
        return self._reader.read(t)
