"""Entry points over the kernel wrappers.

Counterpart of ``repro/kernels/ops.py``: the codec's two kernels on the
main path, the batched decode of the serve plane, and ``level_surplus`` /
``vtotal_with_bound`` over the hierarchical-surplus and fused-Vtotal
kernels.  Unlike the JAX module there is one decode path: on a CUDA device
every call launches the CUDA kernel, whatever the group size, and on the
CPU it runs the kernel's plain version.  The kernels take a run-time plane
count and 64-bit shifts, so the JAX module's hi/lo uint32 split has no
counterpart, and its plane padding (which bounds its jit cache) survives
only as the decode batcher's bucket key (:func:`plane_slots`): no zero
plane is ever built or read.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.bitplane_pack import bitplane_pack
from repro_torch.kernels.bitplane_unpack import bitplane_unpack, \
    bitplane_unpack_batch
from repro_torch.kernels.hier_level import hier_level_surplus
from repro_torch.kernels.qoi_vtotal import qoi_vtotal


def encode_magnitude_planes(c: torch.Tensor, scale: float,
                            nbits: int) -> torch.Tensor:
    """(N,) float64 coefficients -> (nbits, ceil32(N)) int32 packed planes
    of mag = min(floor(|c|*scale), 2^nbits - 1), MSB plane first.
    Quantization and every plane's pack are one kernel launch; the words
    stay on ``c``'s device."""
    return bitplane_pack(c, scale, nbits)


def unpack_bitplanes(words: torch.Tensor, shifts: torch.Tensor,
                     count: int) -> torch.Tensor:
    """(P, ceil32(count)) int32 packed planes + (P,) int64 left shifts ->
    (count,) int64: OR over planes of (unpacked bits << shift)."""
    mag, _ = bitplane_unpack(words, shifts)
    return mag[:count]


def plane_slots(nplanes: int, slots: int = 0) -> int:
    """The plane-axis length the reference's fused decode pads a flush of
    ``nplanes`` planes to: the next power of two of max(nplanes, 1,
    ``slots``) (``repro/kernels/ops.py::_plane_pad``).  The decode batcher
    keys its buckets on it, as the reference does; the kernels read only
    the true planes."""
    n = 1
    while n < max(int(nplanes), 1, int(slots)):
        n <<= 1
    return n


def prepare_fused_decode(words: np.ndarray, shifts, state, sign_bytes,
                         count: int, device: torch.device):
    """Host inputs of one decode -> device tensors in the kernel's
    full-word-length layout: ``words`` (P, W) int32 (the uint32 words
    reinterpreted), ``shifts`` (P,) int64, ``state`` (W*32,) int64 or None,
    ``sign_bytes`` (W*4,) uint8.  The plane words cross host -> device here,
    once per flush; a ``state`` already on the device stays there."""
    nwords = (int(count) + 31) // 32
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if words.size == 0:
        words = words.reshape(0, nwords)
    sh = np.asarray(shifts, dtype=np.int64).reshape(-1)
    if words.shape != (sh.shape[0], nwords):
        raise ValueError(f"words {words.shape} do not match {sh.shape[0]} "
                         f"shifts over {nwords} words")
    if sh.size and (sh.min() < 0 or sh.max() > 63):
        raise ValueError("plane shifts must be in [0, 63]")
    w = as_words(words, device)
    sh_t = torch.from_numpy(sh).to(device)
    st = None
    if state is not None:
        st = torch.as_tensor(state, dtype=torch.int64, device=device)
        if st.shape[0] != nwords * 32:          # count-length carry-in
            st = torch.nn.functional.pad(st, (0, nwords * 32 - st.shape[0]))
    sb = np.zeros(nwords * 4, dtype=np.uint8)
    raw = np.asarray(sign_bytes, dtype=np.uint8)
    sb[: raw.shape[0]] = raw
    return w, sh_t, st, torch.from_numpy(sb).to(device)


def decode_values_fused(words: np.ndarray, shifts, state, sign_bytes,
                        scale: float, count: int, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed plane words -> signed float64 values in one kernel launch.

    ``words`` (P, ceil32(count)) uint32, ``shifts`` per-plane left shifts,
    ``state`` an optional int64 magnitude carry-in (a previous call's
    full-length result, or a (count,) tensor), ``sign_bytes`` the decoded
    packbits sign plane, ``scale`` = 2^(E-B).  Returns device tensors
    ``(mag_full, values)``: ``mag_full`` (W*32,) is the state to feed back,
    ``values`` is sliced to ``count``."""
    w, sh, st, sb = prepare_fused_decode(words, shifts, state, sign_bytes,
                                         count, device)
    mag, vals = bitplane_unpack(w, sh, st, sb, scale)
    return mag, vals[:count]


def decode_values_fused_batch(inputs: Sequence[tuple],
                              scales: Sequence[float],
                              counts: Sequence[int]
                              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """B decodes of one word width in one launch: ``inputs`` are
    :func:`prepare_fused_decode` results ``(words, shifts, state,
    sign_bytes)``, each with its own plane count.  Returns one ``(mag_full,
    values)`` per item, as :func:`decode_values_fused` would, bit for
    bit."""
    words, shifts, states, signs = zip(*inputs)
    out = bitplane_unpack_batch(words, shifts, states, signs, scales)
    return [(mag, vals[:count]) for (mag, vals), count in zip(out, counts)]


def as_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """(P, W) uint32 host words -> int32 device tensor (same bits)."""
    return torch.from_numpy(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    ).to(device)


def level_surplus(x_even: torch.Tensor, x_odd: torch.Tensor) -> torch.Tensor:
    """Batched 1-D surplus ``x_odd - 0.5·(x_even[:, :-1] + x_even[:, 1:])``
    for any (B, M+1), (B, M); one kernel launch on CUDA, the plain version
    on the CPU.  The reference's row padding has no counterpart."""
    return hier_level_surplus(x_even, x_odd)


def vtotal_with_bound(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor,
                      eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Vtotal (value, Thm-2 bound) for flat tensors of any length;
    ``eps`` is three host floats (a tensor is refused: reading it would
    sync).  One kernel launch on CUDA, the plain version on the CPU."""
    return qoi_vtotal(vx, vy, vz, eps)
