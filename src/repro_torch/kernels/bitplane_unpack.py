"""Bitplane decode: OR packed planes into the magnitude state, then sign and
scale the values, in one launch.

Replaces the Pallas kernel ``repro/kernels/bitplane_unpack.py::_kernel``
(entered through ``_unpack`` and driven by
``repro/kernels/ops.py::_unpack_kernel_u64`` with a hi/lo split for shifts
>= 32) together with the fused jnp graph ``ops._decode_fused_body`` that the
JAX reader runs for groups of at least 4096 coefficients.  The CUDA kernel
is ``bitplane_decode`` in ``csrc/bitplane.cu``; its note there says what
bounds it on an H100 (bytes) and how its design follows from that.

:func:`bitplane_unpack_batch` is the batched form the serve plane's decode
batcher runs (replacing the vmapped ``ops._decode_fused_batch``): B groups
of one word width, each with its own plane count, in one launch of
``bitplane_decode_batch`` over a grid of (tiles, B) blocks.

:func:`bitplane_unpack` launches the kernel for CUDA tensors and runs the
plain version :func:`bitplane_unpack_plain` for CPU tensors; for any other
device it raises.  There is no size cutover: every group decodes through the
kernel on the card, however small.  The two are bit-equal.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bitplane_unpack_batch_plain, \
    decode_fused_ref

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


def _check_batch(words, shifts, states, sign_bytes, scales) -> None:
    nb = len(words)
    if not (len(shifts) == len(states) == len(sign_bytes) == len(scales)
            == nb):
        raise ValueError(f"bitplane_unpack_batch: {nb} words but "
                         f"{len(shifts)} shifts, {len(states)} states, "
                         f"{len(sign_bytes)} sign bytes, {len(scales)} "
                         f"scales")
    for args in zip(words, shifts, states, sign_bytes):
        _check(*args)
    if len({w.shape[1] for w in words}) > 1 or \
            len({w.device for w in words}) > 1:
        raise ValueError("bitplane_unpack_batch: the groups must share one "
                         "word width and one device")


def bitplane_unpack_batch(words: Sequence[torch.Tensor],
                          shifts: Sequence[torch.Tensor],
                          states: Sequence[Optional[torch.Tensor]],
                          sign_bytes: Sequence[Optional[torch.Tensor]],
                          scales: Sequence[float]
                          ) -> List[Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]]:
    """:func:`bitplane_unpack` of B groups at once: item b decodes
    ``words[b]`` (P_b, W) with ``shifts[b]``, ``states[b]``,
    ``sign_bytes[b]`` and ``scales[b]``, every group of the same W but each
    with its own plane count P_b <= 64.  Returns one ``(mag, vals)`` per
    group, each its own tensors, bit-equal to B calls of
    :func:`bitplane_unpack`.  One launch on CUDA (none for W = 0 or B = 0),
    the plain version on the CPU."""
    if not words:
        return []
    dev = words[0].device
    if dev.type == "cpu":
        _check_batch(words, shifts, states, sign_bytes, scales)
        if any(s.numel() and (int(s.min()) < 0 or int(s.max()) > 63)
               for s in shifts):
            raise ValueError("bitplane_unpack_batch: shifts must be in "
                             "[0, 63]")
        return bitplane_unpack_batch_plain(words, shifts, states, sign_bytes,
                                           scales)
    if dev.type != "cuda":
        raise ValueError(f"bitplane_unpack_batch: unsupported device {dev}")
    _check_batch(words, shifts, states, sign_bytes, scales)
    nb, nwords = len(words), words[0].shape[1]
    out = [(torch.empty(nwords * 32, dtype=torch.int64, device=dev),
            None if sb is None else
            torch.empty(nwords * 32, dtype=torch.float64, device=dev))
           for sb in sign_bytes]
    if nwords == 0:
        return out

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    # the (7, B) table of the kernel's note, and the (B,) scales as one
    # more row of float64 bits: one small copy to the card per launch, from
    # pinned memory so the host does not wait for the queued work
    table = np.array(
        [[ptr(w) for w in words], [ptr(s) for s in shifts],
         [w.shape[0] for w in words], [ptr(st) for st in states],
         [ptr(sb) for sb in sign_bytes], [ptr(m) for m, _ in out],
         [ptr(v) for _, v in out],
         np.asarray(scales, dtype=np.float64).view(np.int64)],
        dtype=np.int64)
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    lib = build.load("bitplane")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bitplane_decode_batch(
            table_dev.data_ptr(), table_dev[7].view(torch.float64).data_ptr(),
            nb, nwords, stream)
    build.check(status, "bitplane_decode_batch")
    bitplane_unpack_batch.launches += 1
    return out


bitplane_unpack_batch.launches = 0
