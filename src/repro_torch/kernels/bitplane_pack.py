"""Bitplane encode: quantize float64 coefficients to fixed point and pack
every magnitude plane in one launch.

Replaces the Pallas kernel ``repro/kernels/bitplane_pack.py::_kernel``
(entered through ``pack_planes_traced``), which
``repro/kernels/ops.py::_encode_planes_fused`` fuses with the quantization
and runs twice, on hi and lo uint32 words, for 48-bit magnitudes.  The CUDA
kernel is ``bitplane_encode`` in ``csrc/bitplane.cu``; its note there says
what bounds it on an H100 (bytes: 8 B read, nbits/8 B written per
coefficient) and how its warp bit-transpose design follows from that.

:func:`bitplane_pack` launches the kernel for a CUDA tensor and runs the
plain version :func:`bitplane_pack_plain` for a CPU tensor; for any other
device it raises.  The two are bit-equal.
"""
from __future__ import annotations

import torch

from repro_torch.device import F64
from repro_torch.kernels import build
from repro_torch.kernels.ref import bitplane_pack_ref

MAX_NBITS = 53          # 2^nbits - 1 must be exact in float64


def _check(c: torch.Tensor, nbits: int) -> None:
    if c.dtype != F64:
        raise TypeError(f"bitplane_pack: coefficients must be float64, "
                        f"got {c.dtype}")
    if c.dim() != 1:
        raise ValueError(f"bitplane_pack: coefficients must be 1-D, "
                         f"got shape {tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError("bitplane_pack: coefficients must be contiguous")
    if not 1 <= nbits <= MAX_NBITS:
        raise ValueError(f"bitplane_pack: nbits must be in [1, {MAX_NBITS}],"
                         f" got {nbits}")


def bitplane_pack_plain(c: torch.Tensor, scale: float,
                        nbits: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N,) float64 -> (nbits,
    ceil(N/32)) int32 planes of mag = min(floor(|c|·scale), 2^nbits - 1)."""
    _check(c, nbits)
    n = c.shape[0]
    mag = torch.floor(c.abs() * scale)
    mag = torch.clamp(mag, max=float(2.0 ** nbits - 1)).to(torch.int64)
    padded = torch.zeros(-(-n // 32) * 32, dtype=torch.int64, device=c.device)
    padded[:n] = mag
    return bitplane_pack_ref(padded, nbits)


def bitplane_pack(c: torch.Tensor, scale: float, nbits: int) -> torch.Tensor:
    """(N,) float64 coefficients and ``scale`` = 2^(nbits-E) -> (nbits,
    ceil(N/32)) int32 packed planes, MSB plane first."""
    if c.device.type == "cpu":
        return bitplane_pack_plain(c, scale, nbits)
    if c.device.type != "cuda":
        raise ValueError(f"bitplane_pack: unsupported device {c.device}")
    _check(c, nbits)
    n = c.shape[0]
    nwords = -(-n // 32)
    out = torch.empty((nbits, nwords), dtype=torch.int32, device=c.device)
    if nwords == 0:
        return out
    lib = build.load("bitplane")
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        status = lib.bitplane_encode(c.data_ptr(), float(scale), n, nwords,
                                     nbits, out.data_ptr(), stream)
    build.check(status, "bitplane_encode")
    bitplane_pack.launches += 1
    return out


bitplane_pack.launches = 0
