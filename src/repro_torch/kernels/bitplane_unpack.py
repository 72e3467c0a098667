"""Bitplane decode: OR packed planes into the magnitude state, then sign and
scale the values, in one launch.

Replaces the Pallas kernel ``repro/kernels/bitplane_unpack.py::_kernel``
(entered through ``_unpack`` and driven by
``repro/kernels/ops.py::_unpack_kernel_u64`` with a hi/lo split for shifts
>= 32) together with the fused jnp graph ``ops._decode_fused_body`` that the
JAX reader runs for groups of at least 4096 coefficients.  The CUDA kernel
is ``bitplane_decode`` in ``csrc/bitplane.cu``; its note there says what
bounds it on an H100 (bytes) and how its design follows from that.

:func:`bitplane_unpack` launches the kernel for CUDA tensors and runs the
plain version :func:`bitplane_unpack_plain` for CPU tensors; for any other
device it raises.  There is no size cutover: every group decodes through the
kernel on the card, however small.  The two are bit-equal.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_fused_ref

MAX_PLANES = 64


def _check(words, shifts, state, sign_bytes) -> None:
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"bitplane_unpack: {what}")

    if words.dtype != torch.int32 or shifts.dtype != torch.int64:
        raise TypeError(f"bitplane_unpack: words must be int32 and shifts "
                        f"int64, got {words.dtype} and {shifts.dtype}")
    need(words.dim() == 2, f"words must be (P, W), got {tuple(words.shape)}")
    nplanes, nwords = words.shape
    need(nplanes <= MAX_PLANES, f"at most {MAX_PLANES} planes, got {nplanes}")
    need(tuple(shifts.shape) == (nplanes,),
         f"shifts must be ({nplanes},), got {tuple(shifts.shape)}")
    tensors = [words, shifts]
    if state is not None:
        if state.dtype != torch.int64:
            raise TypeError(f"bitplane_unpack: state must be int64, "
                            f"got {state.dtype}")
        need(tuple(state.shape) == (nwords * 32,),
             f"state must be ({nwords * 32},), got {tuple(state.shape)}")
        tensors.append(state)
    if sign_bytes is not None:
        if sign_bytes.dtype != torch.uint8:
            raise TypeError(f"bitplane_unpack: sign bytes must be uint8, "
                            f"got {sign_bytes.dtype}")
        need(tuple(sign_bytes.shape) == (nwords * 4,),
             f"sign bytes must be ({nwords * 4},), "
             f"got {tuple(sign_bytes.shape)}")
        tensors.append(sign_bytes)
    need(all(t.is_contiguous() for t in tensors),
         "inputs must be contiguous")
    need(all(t.device == words.device for t in tensors),
         "inputs must share one device")


def bitplane_unpack_plain(words: torch.Tensor, shifts: torch.Tensor,
                          state: Optional[torch.Tensor] = None,
                          sign_bytes: Optional[torch.Tensor] = None,
                          scale: float = 1.0
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel (same contract)."""
    _check(words, shifts, state, sign_bytes)
    if shifts.numel() and (int(shifts.min()) < 0 or int(shifts.max()) > 63):
        raise ValueError("bitplane_unpack: shifts must be in [0, 63]")
    return decode_fused_ref(words, shifts, state, sign_bytes, scale)


def bitplane_unpack(words: torch.Tensor, shifts: torch.Tensor,
                    state: Optional[torch.Tensor] = None,
                    sign_bytes: Optional[torch.Tensor] = None,
                    scale: float = 1.0
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mag[i] = state[i] | OR_j bit_i(words[j]) << shifts[j]`` over the
    (W*32,) full-word length; with ``sign_bytes`` also ``vals[i] =
    ±mag[i]·scale``, negative where bit 7 - i%8 of byte i/8 is set.

    ``words`` (P, W) int32 with 0 <= P <= 64, ``shifts`` (P,) int64 in
    [0, 63] (the caller's contract: on CUDA they are not read back to the
    host to check), ``state`` (W*32,) int64 or None (zeros), ``sign_bytes``
    (W*4,) uint8 or None.  Returns ``(mag, vals)``, ``vals`` None without
    sign bytes."""
    if words.device.type == "cpu":
        return bitplane_unpack_plain(words, shifts, state, sign_bytes, scale)
    if words.device.type != "cuda":
        raise ValueError(f"bitplane_unpack: unsupported device "
                         f"{words.device}")
    _check(words, shifts, state, sign_bytes)
    nplanes, nwords = words.shape
    dev = words.device
    mag = torch.empty(nwords * 32, dtype=torch.int64, device=dev)
    vals = None if sign_bytes is None else \
        torch.empty(nwords * 32, dtype=torch.float64, device=dev)
    if nwords == 0:
        return mag, vals
    lib = build.load("bitplane")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bitplane_decode(
            words.data_ptr(), shifts.data_ptr(), nplanes, nwords,
            None if state is None else state.data_ptr(), mag.data_ptr(),
            None if sign_bytes is None else sign_bytes.data_ptr(),
            float(scale), None if vals is None else vals.data_ptr(), stream)
    build.check(status, "bitplane_decode")
    bitplane_unpack.launches += 1
    return mag, vals


bitplane_unpack.launches = 0
