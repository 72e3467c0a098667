"""SZ3-like error-bounded lossy compressor (interpolation predictor), on
tensors.

Counterpart of ``repro/compressors/szlike.py``: multilevel linear-
interpolation prediction with *decoded-value feedback* (the decoder
reproduces the encoder's predictions exactly), uniform quantisation with
bin width 2ε, and an entropy stage (zlib over adaptively-narrowed integer
codes).  Guarantees |x - decode|_inf <= ε by construction of the quantiser.

The predict, quantise and dequantise loop runs in torch on the input's
device through the port's own ``transform/hierarchical.py``, with the
reference's op sequence (``round(r / (2ε))``, then ``pred + code · (2ε)``
as two roundings, never a fused multiply-add); boolean gathers and scatters
run in C order, as numpy's do.  Only the entropy stage is host work: each
level's codes are narrowed on the device by their largest magnitude, copied
to the host once and zlib-compressed at level 1; decompression copies each
level's narrowed codes back once.  Blobs are byte-identical to the JAX
package's.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.transform.hierarchical import (
    _node_mask,
    _pad_dim,
    grid_levels,
    interp_up,
    unpad,
)

# the code dtypes of the entropy stage, narrowest first, by numpy name
_CODE_DTYPES = (("int8", torch.int8, 2 ** 7), ("int16", torch.int16, 2 ** 15),
                ("int32", torch.int32, 2 ** 31))
_TORCH_DTYPE = {name: dt for name, dt, _ in _CODE_DTYPES}
_TORCH_DTYPE["int64"] = torch.int64


@dataclass
class SZCompressed:
    eps: float
    orig_shape: Tuple[int, ...]
    padded_shape: Tuple[int, ...]
    levels: int
    blobs: List[bytes]          # [base_codes, level L-1 codes, ..., level 0]
    dtypes: List[str]
    amax: float = 0.0           # max |x| over the padded grid

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.blobs) + 64  # + header

    @property
    def safe_eps(self) -> float:
        """The quantiser guarantees eps in exact arithmetic; f64 dequant
        rounding can exceed it by a few ulps of the value scale — the
        REPORTED bound (what the QoI estimator consumes) includes that."""
        return self.eps + 8 * np.finfo(np.float64).eps * self.amax


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a float64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F64)
    return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device)


def _pad_to_grid(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Edge-replicate pad every dim to 2^k + 1 on ``x``'s device (the
    tensor form of ``hierarchical.pad_to_grid``: copies, so exact)."""
    orig = tuple(x.shape)
    for ax, n in enumerate(orig):
        t = _pad_dim(n)
        if t != n:
            idx = torch.arange(t, device=x.device).clamp_(max=n - 1)
            x = x.index_select(ax, idx)
    return x, orig


_INT64_MIN = -2 ** 63


def _quantise(resid: torch.Tensor, eps: float) -> torch.Tensor:
    # The divisor is a tensor on resid's device: torch's CUDA kernel divides
    # by a Python scalar as a multiply by its reciprocal, which is not
    # correctly rounded and moves codes beyond 2^53.  np.round and
    # torch.round both round half to even.  The reference's
    # ``.astype(np.int64)`` is x86's cvttsd2si, which gives INT64_MIN for
    # NaN, ±inf and anything outside [-2^63, 2^63); CUDA's cvt saturates
    # instead, so out-of-range codes are set to INT64_MIN explicitly and
    # both devices write the reference's bytes.
    two_eps = torch.full((), 2.0 * eps, dtype=resid.dtype,
                         device=resid.device)
    r = torch.round(resid / two_eps)
    ok = (r >= -2.0 ** 63) & (r < 2.0 ** 63)       # False for NaN
    return torch.where(ok, r.to(torch.int64),
                       torch.full_like(r, _INT64_MIN, dtype=torch.int64))


def _pack_codes(codes: torch.Tensor) -> Tuple[bytes, str]:
    """Narrow the codes on their device, copy them to the host once, and
    zlib them."""
    amax = int(codes.abs().max()) if codes.numel() else 0
    name, arr = "int64", codes
    for dt_name, dt, limit in _CODE_DTYPES:
        if amax < limit:
            name, arr = dt_name, codes.to(dt)
            break
    host = arr.reshape(-1).cpu().numpy()
    return zlib.compress(host.tobytes(), 1), name


def _unpack_codes(blob: bytes, dtype: str, count: int,
                  device: torch.device) -> torch.Tensor:
    """Inflate one level's codes on the host and copy them, still narrow, to
    ``device``."""
    raw = bytearray(zlib.decompress(blob))
    codes = torch.frombuffer(raw, dtype=_TORCH_DTYPE[dtype], count=count) \
        if count else torch.zeros(0, dtype=_TORCH_DTYPE[dtype])
    return codes.to(device).to(torch.int64)


def _slices(ndim: int, stride: int):
    return tuple(slice(None, None, stride) for _ in range(ndim))


def sz_compress(x, eps: float, max_levels: int = 32,
                device: DeviceLike = None) -> SZCompressed:
    """Compress ``x`` (numpy array or tensor) at L-inf bound ``eps``; the
    loop runs on ``device`` (default CUDA; raises without it unless
    ``device="cpu"``)."""
    if eps <= 0:
        raise ValueError("eps must be positive")
    dev = resolve_device(device)
    padded, orig_shape = _pad_to_grid(as_device_tensor(x, dev))
    shape = tuple(padded.shape)
    ndim = len(shape)
    levels = grid_levels(shape, max_levels)
    two_eps = 2.0 * eps
    blobs: List[bytes] = []
    dtypes: List[str] = []

    # Base grid: predict 0, quantise absolute values.
    base_sl = _slices(ndim, 1 << levels)
    codes = _quantise(padded[base_sl], eps)
    blob, dt = _pack_codes(codes)
    blobs.append(blob)
    dtypes.append(dt)
    decoded = torch.zeros(shape, dtype=F64, device=dev)
    decoded[base_sl] = codes.to(F64) * two_eps

    # Fine levels, coarse -> fine, predicting from *decoded* values.
    for l in range(levels - 1, -1, -1):
        sl = _slices(ndim, 1 << l)
        view = padded[sl]
        dec_view = decoded[sl]
        pred = interp_up(dec_view[_slices(ndim, 2)])
        mask = _node_mask(tuple(view.shape), dev)
        pred_new = pred[mask]
        codes = _quantise(view[mask] - pred_new, eps)
        blob, dt = _pack_codes(codes)
        blobs.append(blob)
        dtypes.append(dt)
        dec_view = dec_view.clone()
        dec_view[mask] = pred_new + codes.to(F64) * two_eps
        decoded[sl] = dec_view

    return SZCompressed(eps=float(eps), orig_shape=orig_shape,
                        padded_shape=shape, levels=levels,
                        blobs=blobs, dtypes=dtypes,
                        amax=float(padded.abs().max()))


def sz_decompress(c: SZCompressed, device: DeviceLike = None
                  ) -> torch.Tensor:
    """Decode ``c`` on ``device`` (default CUDA); returns a tensor of its
    original shape there."""
    dev = resolve_device(device)
    ndim = len(c.padded_shape)
    two_eps = 2.0 * c.eps
    decoded = torch.zeros(c.padded_shape, dtype=F64, device=dev)
    base_sl = _slices(ndim, 1 << c.levels)
    base_shape = decoded[base_sl].shape
    codes = _unpack_codes(c.blobs[0], c.dtypes[0], int(np.prod(base_shape)),
                          dev)
    decoded[base_sl] = codes.reshape(base_shape).to(F64) * two_eps
    for i, l in enumerate(range(c.levels - 1, -1, -1)):
        sl = _slices(ndim, 1 << l)
        dec_view = decoded[sl]
        pred = interp_up(dec_view[_slices(ndim, 2)])
        view_shape = tuple(dec_view.shape)
        mask = _node_mask(view_shape, dev)
        # new nodes: all of the view but its 2-strided coarse grid
        count = int(np.prod(view_shape)) - \
            int(np.prod([(n + 1) // 2 for n in view_shape]))
        codes = _unpack_codes(c.blobs[i + 1], c.dtypes[i + 1], count, dev)
        dec_view = dec_view.clone()
        dec_view[mask] = pred[mask] + codes.to(F64) * two_eps
        decoded[sl] = dec_view
    return unpad(decoded, c.orig_shape)
