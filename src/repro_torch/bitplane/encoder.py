"""Sign-magnitude fixed-point bitplane encoding (progression in precision).

Counterpart of ``repro/bitplane/encoder.py``; the archive format is the
reference's, byte for byte.  Per coefficient group:

  * shared exponent  E = ceil(log2 max|c|)  so |c| / 2^E in [0, 1);
  * magnitudes quantised to B-bit fixed point: mag = floor(|c| · 2^{B-E});
  * plane b (0 = MSB) is bit (B-1-b) of every magnitude, 32 coefficients
    per uint32 word (bit i of word w = coefficient 32·w + i), each plane a
    tagged blob of the entropy stage (``codecs.encode_tagged``);
  * one sign plane (packbits of c < 0), charged to the first fetched plane.

Quantization and packing run on the coefficients' device in one kernel
launch (``kernels/bitplane_pack``); the packed words then cross to the host
once for the entropy stage, which stays numpy/zlib as in the reference.
Decoding inflates blobs on the host and ORs the planes, signs and scales on
the device (``kernels/bitplane_unpack``).

Retrieving the first k planes bounds the coefficient error by

    err(k) <= 2^{E-k} + 2^{E-B}          (truncation + quantisation)
"""
from __future__ import annotations

from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bitplane.codecs import decode_sign_blob, decode_tagged, \
    encode_tagged
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.kernels import ops

DEFAULT_NBITS = 48  # magnitude planes; int64-safe, ~1e-14 relative floor


def _popcounts(words: np.ndarray) -> np.ndarray:
    """Per-plane set-bit counts of (P, W) uint32 packed words."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=1)
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1,
                                                           dtype=np.int64)


def _inflate_plane(blob: bytes, nwords: int) -> np.ndarray:
    return np.frombuffer(decode_tagged(blob, 4 * nwords), dtype=np.uint32,
                         count=nwords)


@dataclass(frozen=True)
class PlaneGroupMeta:
    """Payload-free description of one encoded coefficient group: what a
    progressive reader needs to plan fetches and decode received planes."""
    count: int
    exponent: Optional[int]        # None => group is all zeros
    nbits: int
    plane_sizes: Tuple[int, ...]   # encoded bytes per plane, MSB-first
    sign_size: int
    pred_planes: Optional[int] = None  # `ip` only: planes folded into the
                                       # encoder's closed-loop prediction


@dataclass
class LevelBitplanes:
    """Encoded bitplanes of one coefficient group."""
    count: int                      # number of coefficients
    exponent: Optional[int]        # None => group is all zeros
    nbits: int
    planes: List[bytes]            # tagged packed-word planes, MSB-first
    plane_raw_bits: int            # uncompressed bits per plane (= count)
    signs: bytes                   # codec-tagged packbits(c < 0)
    pred_planes: Optional[int] = None  # see PlaneGroupMeta.pred_planes
    _crcs: Optional[Tuple[Tuple[int, ...], int]] = field(
        default=None, repr=False, compare=False)

    def plane_nbytes(self, b: int) -> int:
        return len(self.planes[b])

    @property
    def sign_nbytes(self) -> int:
        return len(self.signs)

    @property
    def total_nbytes(self) -> int:
        if self.exponent is None:
            return 0
        return sum(len(p) for p in self.planes) + len(self.signs)

    def meta(self) -> PlaneGroupMeta:
        return PlaneGroupMeta(count=self.count, exponent=self.exponent,
                              nbits=self.nbits,
                              plane_sizes=tuple(len(p) for p in self.planes),
                              sign_size=len(self.signs),
                              pred_planes=self.pred_planes)

    def segment_crcs(self) -> Tuple[Tuple[int, ...], int]:
        """(per-plane crc32c, sign crc32c), computed on first use: the store
        manifest records them and the fetcher re-verifies every segment it
        delivers."""
        if self._crcs is None:
            from repro_torch.store.crc import crc32c
            self._crcs = (tuple(crc32c(p) for p in self.planes),
                          crc32c(self.signs))
        return self._crcs


def encode_level(coeffs: torch.Tensor, nbits: int = DEFAULT_NBITS,
                 executor: Optional[Executor] = None) -> LevelBitplanes:
    """Encode one group's coefficients (a float64 tensor on any device).
    With ``executor`` (a process pool: the codecs run Python loops under
    the interpreter lock) the planes' entropy stage is mapped over it; the
    blobs are the same."""
    c = coeffs.reshape(-1).to(F64).contiguous()
    n = c.numel()
    amax = float(c.abs().max()) if n else 0.0
    if amax == 0.0 or n == 0:
        return LevelBitplanes(count=n, exponent=None, nbits=nbits, planes=[],
                              plane_raw_bits=n, signs=b"")
    e = int(np.ceil(np.log2(amax)))
    if 2.0 ** e == amax:  # make |c|/2^E < 1 strict
        e += 1
    # quantization + per-plane pack: ONE kernel launch (scaling by
    # 2^(nbits-e) is exact — a power of two); the words cross to the host
    # once, for the entropy stage
    scale = np.float64(2.0) ** (nbits - e)
    words = ops.encode_magnitude_planes(c, float(scale), nbits)
    words = words.cpu().numpy().view(np.uint32)
    density = _popcounts(words) / float(n)
    datas = (words[b].tobytes() for b in range(nbits))
    dens = (float(density[b]) for b in range(nbits))
    planes = list((executor.map if executor else map)(encode_tagged, datas,
                                                      dens))
    signs = encode_tagged(np.packbits((c < 0).cpu().numpy()).tobytes())
    return LevelBitplanes(count=n, exponent=e, nbits=nbits, planes=planes,
                          plane_raw_bits=n, signs=signs)


def inflate_planes(count: int, nbits: int, blobs: Sequence[bytes],
                   start: int, executor: Optional[Executor] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encoded plane blobs -> ((P, W) uint32 packed words, (P,) int64
    shifts) for the device decode.  Pure inflation, on the host (mapped
    over ``executor`` when one is given)."""
    nwords = (count + 31) // 32
    words = np.empty((len(blobs), nwords), dtype=np.uint32)
    planes = (executor.map if executor else map)(
        _inflate_plane, blobs, [nwords] * len(blobs))
    for i, plane in enumerate(planes):
        words[i] = plane
    shifts = np.asarray([nbits - 1 - b
                         for b in range(start, start + len(blobs))],
                        dtype=np.int64)
    return words, shifts


def sign_plane_bytes(count: int, signs_blob: bytes) -> np.ndarray:
    """Decoded packbits(c < 0) bytes for the fused device decode."""
    return np.frombuffer(decode_sign_blob(signs_blob, (count + 7) // 8),
                         dtype=np.uint8)


def accumulate_planes(count: int, nbits: int, blobs: Sequence[bytes],
                      start: int, state: Optional[torch.Tensor] = None,
                      device: DeviceLike = None) -> torch.Tensor:
    """OR encoded plane blobs (planes ``start .. start+len(blobs)``, MSB
    numbering) into an int64 (count,) magnitude state: ``state``'s device
    when one is given, else ``device`` (default CUDA)."""
    if state is not None:
        device = state.device
    else:
        device = resolve_device(device)
    mag = state if state is not None else \
        torch.zeros(count, dtype=torch.int64, device=device)
    if not blobs:
        return mag
    words, shifts = inflate_planes(count, nbits, blobs, start)
    return mag | ops.unpack_bitplanes(ops.as_words(words, device),
                                      torch.from_numpy(shifts).to(device),
                                      count)


def decode_magnitudes(lbp: LevelBitplanes, k: int,
                      state: Optional[torch.Tensor] = None, start: int = 0,
                      device: DeviceLike = None) -> torch.Tensor:
    """Accumulate planes [start, k) of a group into an int64 (count,)
    magnitude state holding the uint64 pattern (incremental recomposition,
    Definition 1(2)): on ``state``'s device when one is given, else on
    ``device`` (default CUDA).  On the card the OR is one launch of the
    decode kernel (``ops.unpack_bitplanes``)."""
    device = state.device if state is not None else resolve_device(device)
    if lbp.exponent is None:
        return torch.zeros(lbp.count, dtype=torch.int64, device=device)
    k = min(k, lbp.nbits)
    if start >= k:
        return state if state is not None else \
            torch.zeros(lbp.count, dtype=torch.int64, device=device)
    return accumulate_planes(lbp.count, lbp.nbits, lbp.planes[start:k],
                             start, state, device)


def values_from_planes(count: int, exponent: Optional[int], nbits: int,
                       mag: torch.Tensor, signs_blob: bytes) -> torch.Tensor:
    """Magnitude state + encoded sign segment -> float64 coefficient values
    on the state's device (blob-level counterpart of ``decode_values``)."""
    if exponent is None:
        return torch.zeros(count, dtype=F64, device=mag.device)
    signs = np.unpackbits(sign_plane_bytes(count, signs_blob),
                          count=count).astype(bool)
    m = mag[:count]
    # the magnitude is unsigned (a 64-plane group sets bit 63): both 32-bit
    # halves convert exactly and the sum rounds once, as uint64 -> float64
    unsigned = (((m >> 32) & 0xFFFFFFFF).to(F64) * 4294967296.0
                + (m & 0xFFFFFFFF).to(F64))
    vals = unsigned * float(np.float64(2.0) ** (exponent - nbits))
    return torch.where(torch.from_numpy(signs).to(mag.device), -vals, vals)


def decode_values(lbp: LevelBitplanes, mag: torch.Tensor) -> torch.Tensor:
    """Magnitude state + signs -> float64 coefficient values."""
    return values_from_planes(lbp.count, lbp.exponent, lbp.nbits, mag,
                              lbp.signs)


def decode_prefix(lbp: LevelBitplanes, k: int, device: DeviceLike = None,
                  executor: Optional[Executor] = None) -> torch.Tensor:
    """First-k-planes decode of a group: one fused decode launch (unpack,
    sign and scale) on ``device`` (default CUDA); the planes inflate on the
    host, over ``executor`` when one is given."""
    device = resolve_device(device)
    if lbp.exponent is None:
        return torch.zeros(lbp.count, dtype=F64, device=device)
    k = min(k, lbp.nbits)
    words, shifts = inflate_planes(lbp.count, lbp.nbits, lbp.planes[:k], 0,
                                   executor)
    scale = np.float64(2.0) ** (lbp.exponent - lbp.nbits)
    _, vals = ops.decode_values_fused(
        words, shifts, None, sign_plane_bytes(lbp.count, lbp.signs),
        float(scale), lbp.count, device)
    return vals


def plane_bound(lbp: LevelBitplanes, k: int) -> float:
    """Guaranteed |c - ĉ|_inf after retrieving the first k planes."""
    if lbp.exponent is None:
        return 0.0
    k = min(k, lbp.nbits)
    trunc = 2.0 ** (lbp.exponent - k) if k < lbp.nbits else 0.0
    return trunc + 2.0 ** (lbp.exponent - lbp.nbits)


def planes_needed(lbp: LevelBitplanes, eps: float) -> int:
    """Smallest k with plane_bound(k) <= eps (nbits if unreachable)."""
    if lbp.exponent is None:
        return 0
    quant = 2.0 ** (lbp.exponent - lbp.nbits)
    if eps <= quant:
        return lbp.nbits
    # 2^{E-k} <= eps - quant  =>  k >= E - log2(eps - quant)
    k = int(np.ceil(lbp.exponent - np.log2(eps - quant)))
    return int(np.clip(k, 0, lbp.nbits))
