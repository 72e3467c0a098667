"""Progressive segment streams: incremental per-group plane retrieval state.

Counterpart of ``repro/bitplane/segments.py``.  A LevelStream tracks how
many planes of one coefficient group have been moved (bytes are charged
once per plane) and keeps the group's decode state — the int64 magnitude
state and the float64 values — on its device between requests.  Newly
fetched planes are inflated on the host at fetch time and deferred; the
next ``values()`` flushes them in ONE fused decode launch that ORs them
into the device state, signs and scales — or, with a shared
``serve.DecodeBatcher``, queues that flush so concurrent readers' flushes
of one word width share one batched launch.  Decoded values depend only on the
final plane count, whatever the fetch schedule and whatever the source: an
in-memory group or a store-backed one that fetches checksum-verified
segments through a ``SegmentFetcher`` (``repro_torch.store``).

``prefetch_to_planes`` forwards a hint to the source, whose fetcher threads
move the bytes in the background; nothing of the device is touched off the
caller's thread.  A segment that is permanently unavailable pins the stream
at the deepest contiguous plane prefix it could decode (degraded mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.bitplane.encoder import (
    LevelBitplanes,
    PlaneGroupMeta,
    inflate_planes,
    plane_bound,
    sign_plane_bytes,
)
from repro_torch.device import F64
from repro_torch.kernels import ops


class _Ready:
    """Ticket of a decode launched inline (no batcher)."""

    def __init__(self, res):
        self._res = res

    def result(self):
        return self._res


@dataclass
class PlaneSegment:
    """Address and size of one encoded plane segment."""
    level: int
    plane: int
    nbytes: int


class PlaneSource:
    """Access to one coefficient group's encoded segments: ``meta`` is
    always resident, payload bytes come on demand."""

    meta: PlaneGroupMeta

    def planes(self, start: int, stop: int) -> Sequence[bytes]:
        raise NotImplementedError

    def planes_available(self, start: int, stop: int):
        """Deliverable prefix of planes [start, stop): ``(buffers, error)``,
        with ``error`` None only when every plane arrived.  A bitplane
        prefix is useful exactly as far as it is contiguous, so a source
        that can fail partially (store-backed) overrides this to return
        what it got; the default is all-or-nothing via ``planes``."""
        try:
            return list(self.planes(start, stop)), None
        except Exception as e:
            return [], e

    def signs(self) -> bytes:
        raise NotImplementedError

    def prefetch(self, start: int, stop: int, certain: bool = True) -> None:
        """Hint that planes [start, stop) will be requested; ``certain=False``
        marks a speculative prediction the reader may never follow up on."""


class InMemoryPlaneSource(PlaneSource):
    """Planes held by a `LevelBitplanes` in host memory."""

    def __init__(self, lbp: LevelBitplanes):
        self.lbp = lbp
        self.meta = lbp.meta()

    def planes(self, start: int, stop: int) -> Sequence[bytes]:
        return self.lbp.planes[start:stop]

    def signs(self) -> bytes:
        return self.lbp.signs


class LevelStream:
    """Progressive reader state over one group's PlaneSource, decoding on
    ``device`` (through ``batcher``, a shared ``serve.DecodeBatcher``, when
    one is given)."""

    def __init__(self, source: Union[PlaneSource, LevelBitplanes],
                 device: torch.device, batcher=None):
        if isinstance(source, LevelBitplanes):
            source = InMemoryPlaneSource(source)
        self.source = source
        self.meta = source.meta
        self.device = device
        self.batcher = batcher
        self.fetched = 0
        self.bytes_fetched = 0
        # degraded mode: deepest reachable plane count once a segment of
        # this group proved permanently unavailable (None = fully available)
        self.pinned: Optional[int] = None
        self.pin_error: Optional[BaseException] = None
        # full-word-length (W*32,) int64 magnitude state on the device
        self._mag: Optional[torch.Tensor] = None
        self._signs: Optional[bytes] = None
        self._sign_bytes: Optional[np.ndarray] = None
        self._values: Optional[torch.Tensor] = None
        # planes fetched since the last flush, inflated on the host
        self._pending_words: list = []
        self._pending_shifts: list = []

    def _pin(self, k: int, err: BaseException) -> None:
        self.pinned = k
        self.pin_error = err

    def fetch_to_planes(self, k: int) -> int:
        """Retrieve planes up to k (MSB-first). Returns newly moved bytes.

        A permanently unavailable segment does not raise: the stream pins
        at the deepest contiguous plane prefix it could decode — its bound
        (computed from the planes actually decoded) stays valid, just wider
        than requested — and records the cause in ``pin_error``."""
        meta = self.meta
        k = int(np.clip(k, 0, meta.nbits))
        if self.pinned is not None:
            k = min(k, self.pinned)
        if meta.exponent is None or k <= self.fetched:
            return 0
        if self.fetched == 0 and self._signs is None:
            try:
                self._signs = self.source.signs()
            except Exception as e:       # no signs -> no usable plane 0
                self._pin(0, e)
                return 0
        blobs, err = self.source.planes_available(self.fetched, k)
        got = self.fetched + len(blobs)
        # signs ride with the first plane: their bytes are charged when a
        # plane actually lands
        new_bytes = sum(meta.plane_sizes[self.fetched:got])
        if self.fetched == 0 and got > 0:
            new_bytes += meta.sign_size
        if blobs:
            words, shifts = inflate_planes(meta.count, meta.nbits, blobs,
                                           self.fetched)
            self._pending_words.append(words)
            self._pending_shifts.append(shifts)
            self.fetched = got
            self.bytes_fetched += new_bytes
            self._values = None
        if err is not None:
            self._pin(self.fetched, err)
        return new_bytes if blobs else 0

    def prefetch_to_planes(self, k: int, certain: bool = True) -> None:
        """Hint the source that planes up to ``k`` will be requested; a
        store-backed source starts moving planes [fetched, k) in the
        background.  Never changes decode state or byte accounting."""
        meta = self.meta
        if meta.exponent is None:
            return
        k = int(np.clip(k, 0, meta.nbits))
        if self.pinned is not None:
            k = min(k, self.pinned)    # never speculate past the pin
        if k > self.fetched:
            self.source.prefetch(self.fetched, k, certain=certain)

    def _decoded_signs(self) -> np.ndarray:
        if self._sign_bytes is None:
            self._sign_bytes = sign_plane_bytes(self.meta.count, self._signs)
        return self._sign_bytes

    def flush_submit(self):
        """Phase 1 of the deferred flush: hand every pending plane to the
        decode batcher, or launch the fused decode inline when there is
        none.  Returns a ticket for ``flush_collect``, or None when nothing
        is pending.  Split in two so a caller draining many streams can
        submit them all before collecting any — one batched launch per
        word width instead of one per stream."""
        if not self._pending_words:
            return None
        meta = self.meta
        words = np.concatenate(self._pending_words, axis=0)
        shifts = np.concatenate(self._pending_shifts)
        self._pending_words.clear()
        self._pending_shifts.clear()
        scale = float(np.float64(2.0) ** (meta.exponent - meta.nbits))
        sb = self._decoded_signs()
        if self.batcher is not None:
            return self.batcher.submit_decode(words, shifts, self._mag, sb,
                                              scale, meta.count, self.device)
        return _Ready(ops.decode_values_fused(words, shifts, self._mag, sb,
                                              scale, meta.count,
                                              self.device))

    def flush_collect(self, ticket) -> None:
        """Phase 2: adopt the decode result as the stream's state."""
        if ticket is None:
            return
        self._mag, self._values = ticket.result()

    def values(self) -> torch.Tensor:
        """Decoded float64 values (count,) on the device."""
        if self._values is None:
            if self.fetched == 0:
                self._values = torch.zeros(self.meta.count, dtype=F64,
                                           device=self.device)
            else:
                self.flush_collect(self.flush_submit())
        return self._values

    @property
    def bound(self) -> float:
        return plane_bound(self.meta, self.fetched)

    def reset(self) -> None:
        """Forget every fetched plane and the pin, so a re-read can find a
        healed segment."""
        self.fetched = 0
        self.bytes_fetched = 0
        self.pinned = None
        self.pin_error = None
        self._mag = None
        self._signs = None
        self._sign_bytes = None
        self._values = None
        self._pending_words.clear()
        self._pending_shifts.clear()
