"""Bitplane gradient compression with error feedback.

Counterpart of ``repro/train/grad_compress.py``: per leaf, gradients are
quantised to the top ``k_planes`` bitplanes of a shared power-of-two
exponent (int32 codes), dequantised, and the residual fed back into the
next step's gradient.  ``compressed_psum`` is the data-parallel mean over
a mesh dim's process group that sums the codes instead of float32.

The shared exponent is ``ceil(log2(max(amax, 1e-30)))`` and the scale
``exp2(e)``, in float32, which jax lowers to ``log(x) / log(2)`` and
``exp(ln2 * e)`` with XLA's own float32 ``log`` and ``exp``.  So the
reference's scale is not a power of two for most exponents outside
[-12, 12], and near some powers of two its exponent is one off the true
ceiling.  The port computes neither: both are finite tables of the
reference's own values (``_E_EDGE_BITS``, ``_SCALE_BITS``), so codes,
scale and feedback equal the reference's for every amax, on any device.

Unlike the reference, :func:`compress_decompress` and
:func:`compressed_psum` write the new residuals into the feedback tensors
they are given and return them (one fp32 copy of the model's size saved at
every step).  Each call of :func:`compress_decompress` is one
``repro_torch.compress`` span (``repro_torch.spans``), recording each
leaf's size and dtype.

:func:`compressed_psum` follows the reference's code, not its docstring:
the wire is ``sum_safe_int_dtype(k, n_ranks or 64)``, so k = 4 over 16
ranks rides int16 (9 bits), not int8.  Neither gloo nor NCCL sums 16-bit
integers, so an int16 wire is lane-packed: each code biased by 2^k into
[0, 2^(k+1)], the low lane's, with a signed code in the high lane, two
codes to an int32 word.  Whenever ``n * 2^(k+1) < 2^16`` (every group of up
to ``n_ranks`` ranks) the lanes sum with no carry between them, so the sum
is the reference's int16 sum exactly, at 2 bytes a code.  Otherwise (a
group larger than the wire was chosen for, or a rank whose amax was NaN,
whose codes may saturate) the codes are widened to int32 on the wire and
the sum wrapped to int16 after it, as the reference's int16 sum wraps.
int8 and int32 wires are summed as they are.  The cross-rank amax is the
reference's on XLA's CPU backend: a rank's NaN amax drops out of the max
(and a max of NaNs only is -inf, so the exponent is the clamp's), while a
one-rank group keeps its NaN; a code out of the wire's range saturates and
a NaN code is 0, as XLA converts.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.train.pytree import tree_leaves, tree_map

Pytree = Any

# The reference's exponent and scale as tables, float32 bit patterns.
# _E_EDGE_BITS[i] is the largest amax whose exponent is -99 + i (i = 0 ..
# 226: e = -99 .. 127); every larger amax, inf included, has e = 128.  The
# exponent is monotone in amax, so e = -99 + the number of edges below amax
# (amax at or under the first edge takes e = -99, which the reference's
# clamp to 1e-30 gives).  _SCALE_BITS[j] is the reference's exp2(-99 + j),
# j = 0 .. 227 (e = 128 gives inf).  Both are read off scalar calls of
# ``jax.jit(repro.train.grad_compress._quantise)``, as the reference's train
# step runs it (the edges by bisection over float32 bit patterns);
# ``tests/test_torch_train.py::test_quantise_tables_equal_the_reference``
# regenerates them and holds them to these literals.
_E_EDGE_BITS = (
    0x0e000002, 0x0e7fffec, 0x0f00002a, 0x0f80001e, 0x10000012, 0x10800006,
    0x10fffff5, 0x1180001e, 0x12000012, 0x12800006, 0x1300001a, 0x1380000e,
    0x14000002, 0x14800016, 0x1500000a, 0x1580001e, 0x16000012, 0x16800006,
    0x1700001a, 0x1780000e, 0x18000002, 0x18800016, 0x1900000a, 0x1980001e,
    0x1a000012, 0x1a800006, 0x1b00001a, 0x1b80000e, 0x1c000002, 0x1c800016,
    0x1d00000a, 0x1d80001e, 0x1e000012, 0x1e800006, 0x1f00001a, 0x1f80000e,
    0x20000002, 0x207fffee, 0x2100000b, 0x217ffffe, 0x22000013, 0x22800007,
    0x22fffff6, 0x2380000f, 0x24000003, 0x247fffee, 0x2500000b, 0x257ffffe,
    0x26000013, 0x26800007, 0x26fffff6, 0x2780000f, 0x28000003, 0x2880000f,
    0x29000003, 0x29800007, 0x2a00000b, 0x2a80000f, 0x2b000003, 0x2b800007,
    0x2c00000b, 0x2c80000f, 0x2d000003, 0x2d800007, 0x2e00000b, 0x2e80000f,
    0x2f000003, 0x2f800007, 0x2ffffff7, 0x307fffff, 0x31000003, 0x31800007,
    0x31fffff7, 0x327fffff, 0x33000003, 0x33800007, 0x34000007, 0x34800003,
    0x35000007, 0x35800003, 0x36000007, 0x36800003, 0x37000007, 0x37800003,
    0x37ffffff, 0x38800003, 0x38ffffff, 0x39800003, 0x3a000001, 0x3a800001,
    0x3b000001, 0x3b800001, 0x3c000001, 0x3c800001, 0x3d000000, 0x3d800000,
    0x3e000000, 0x3e800000, 0x3f000000, 0x3f800000, 0x40000000, 0x40800000,
    0x41000001, 0x41800001, 0x42000001, 0x42800002, 0x43000002, 0x43800002,
    0x44000002, 0x44800002, 0x45000002, 0x45800004, 0x46000000, 0x46800004,
    0x47000000, 0x47800004, 0x48000008, 0x48800004, 0x49000008, 0x49800004,
    0x4a000008, 0x4a800004, 0x4b000008, 0x4b800008, 0x4c00000c, 0x4c800000,
    0x4d000004, 0x4d800008, 0x4e00000c, 0x4e800000, 0x4f000004, 0x4f800008,
    0x5000000c, 0x50800010, 0x51000014, 0x51800008, 0x5200000c, 0x52800010,
    0x53000014, 0x53800008, 0x5400000c, 0x54800010, 0x55000014, 0x55800008,
    0x5600000c, 0x56800010, 0x5700001c, 0x57800010, 0x58000004, 0x58800018,
    0x5900000c, 0x59800000, 0x5a000014, 0x5a800008, 0x5b00001c, 0x5b800010,
    0x5c000004, 0x5c800018, 0x5d00000c, 0x5d800000, 0x5e000014, 0x5e800008,
    0x5f00001d, 0x5f800011, 0x60000025, 0x60800019, 0x6100000d, 0x61800021,
    0x62000015, 0x62800029, 0x6300001d, 0x63800011, 0x64000025, 0x64800019,
    0x6500000d, 0x65800021, 0x66000015, 0x66800029, 0x6700001d, 0x67800011,
    0x68000025, 0x68800019, 0x6900000d, 0x69800021, 0x6a000015, 0x6a800029,
    0x6b00001d, 0x6b800011, 0x6c000025, 0x6c800019, 0x6d00000d, 0x6d800021,
    0x6e000005, 0x6e800039, 0x6f00002d, 0x6f800021, 0x70000015, 0x70800009,
    0x7100003d, 0x71800031, 0x72000025, 0x72800019, 0x7300000d, 0x73800001,
    0x74000035, 0x74800029, 0x7500001d, 0x75800011, 0x76000005, 0x76800039,
    0x7700002d, 0x77800021, 0x78000015, 0x78800009, 0x7900003d, 0x79800031,
    0x7a000025, 0x7a800019, 0x7b00000d, 0x7b800001, 0x7c000035, 0x7c800029,
    0x7d00001d, 0x7d800011, 0x7e000005, 0x7e80003a, 0x7f00002e,
)

_SCALE_BITS = (
    0x0dffffc5, 0x0e800016, 0x0f00000a, 0x0f7ffffd, 0x0fffffe5, 0x107fffcd,
    0x1100001b, 0x1180000f, 0x12000003, 0x127fffed, 0x1300000b, 0x137ffffd,
    0x13ffffe5, 0x14800007, 0x14fffff5, 0x157fffdd, 0x16000003, 0x167fffed,
    0x1700000b, 0x177ffffd, 0x17ffffe5, 0x18800007, 0x18fffff6, 0x1980000f,
    0x1a000003, 0x1a7fffee, 0x1b00000b, 0x1b7ffffe, 0x1bffffe6, 0x1c800007,
    0x1cfffff6, 0x1d7fffde, 0x1e000003, 0x1e7fffee, 0x1f00000b, 0x1f7ffffe,
    0x1fffffe6, 0x20800007, 0x20fffff6, 0x2180000f, 0x22000003, 0x227fffee,
    0x2300000b, 0x237ffffe, 0x23ffffe6, 0x24800007, 0x24fffff6, 0x257fffde,
    0x26000003, 0x267fffee, 0x2700000b, 0x277ffffe, 0x27ffffe6, 0x28800007,
    0x28fffff7, 0x297fffff, 0x2a000003, 0x2a7fffef, 0x2afffff7, 0x2b7fffff,
    0x2c000003, 0x2c800007, 0x2cfffff7, 0x2d7fffff, 0x2e000003, 0x2e7fffef,
    0x2efffff7, 0x2f7fffff, 0x30000004, 0x30800008, 0x30fffff7, 0x317fffff,
    0x32000004, 0x327fffef, 0x32fffff7, 0x337fffff, 0x34000004, 0x347fffff,
    0x34fffff7, 0x357fffff, 0x36000004, 0x367fffff, 0x36fffff7, 0x377fffff,
    0x38000004, 0x38800000, 0x38fffff8, 0x39800000, 0x3a000000, 0x3a800000,
    0x3b000000, 0x3b800000, 0x3c000000, 0x3c800000, 0x3d000000, 0x3d800000,
    0x3e000000, 0x3e800000, 0x3f000000, 0x3f800000, 0x40000000, 0x40800000,
    0x41000000, 0x41800000, 0x42000000, 0x42800000, 0x43000000, 0x43800000,
    0x44000000, 0x44800000, 0x45000000, 0x45800000, 0x46000004, 0x46800000,
    0x46fffff8, 0x47800000, 0x48000004, 0x48800000, 0x48fffff9, 0x49800000,
    0x4a000004, 0x4a800000, 0x4afffff9, 0x4b800000, 0x4c000004, 0x4c800008,
    0x4cfffff9, 0x4d800000, 0x4e000004, 0x4e7ffff1, 0x4efffff9, 0x4f800001,
    0x50000005, 0x50800009, 0x50fffff9, 0x51800001, 0x52000005, 0x527ffff1,
    0x52fffff9, 0x53800001, 0x54000005, 0x54800009, 0x54fffff9, 0x55800001,
    0x56000005, 0x567ffff1, 0x5700000d, 0x57800001, 0x57ffffea, 0x58800009,
    0x58fffffa, 0x59800011, 0x5a000005, 0x5a7ffff2, 0x5b00000d, 0x5b800001,
    0x5bffffea, 0x5c800009, 0x5cfffffa, 0x5d7fffe2, 0x5e000005, 0x5e7ffff2,
    0x5f00000d, 0x5f800001, 0x5fffffea, 0x60800009, 0x60fffffa, 0x61800011,
    0x62000005, 0x627ffff2, 0x6300000d, 0x63800001, 0x63ffffea, 0x64800009,
    0x64fffffa, 0x657fffe2, 0x66000005, 0x667ffff2, 0x6700000d, 0x67800001,
    0x67ffffeb, 0x68800009, 0x68fffffb, 0x69800011, 0x6a000005, 0x6a7ffff3,
    0x6b00000d, 0x6b800001, 0x6bffffeb, 0x6c800009, 0x6cfffffb, 0x6d7fffe3,
    0x6dffffcb, 0x6e80001a, 0x6f00000e, 0x6f800002, 0x6fffffeb, 0x707fffd3,
    0x7100001e, 0x71800012, 0x72000006, 0x727ffff3, 0x72ffffdb, 0x73800022,
    0x74000016, 0x7480000a, 0x74fffffb, 0x757fffe3, 0x75ffffcb, 0x7680001a,
    0x7700000e, 0x77800002, 0x77ffffec, 0x787fffd4, 0x7900001e, 0x79800012,
    0x7a000006, 0x7a7ffff4, 0x7affffdc, 0x7b7fffc4, 0x7c000016, 0x7c80000a,
    0x7cfffffc, 0x7d7fffe4, 0x7dffffcc, 0x7e80001a, 0x7f00000e, 0x7f800000,
)


def zeros_like_feedback(grads: Pytree) -> Pytree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edges, scales) as float32 tensors on ``device``."""
    return tuple(torch.tensor(bits, dtype=torch.int64).to(torch.int32)
                 .view(torch.float32).to(device)
                 for bits in (_E_EDGE_BITS, _SCALE_BITS))


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The reference's scale for a (1,) float32 amax, as a 0-d tensor."""
    from torch._subclasses.fake_tensor import is_fake
    # a fake amax (a dry run's trace) gets tables of its own fake mode
    edges, scales = (_tables.__wrapped__ if is_fake(amax) else _tables)(
        amax.device)
    scale = scales[torch.searchsorted(edges, amax)]
    # a NaN amax: the reference's log, ceil and exp2 carry it to the scale
    return torch.where(torch.isnan(amax), amax, scale).reshape(())


def _quantise(g: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int32 codes in [-2^k, 2^k], the reference's scale)."""
    g32 = g.to(torch.float32)
    scale = _scale_of(torch.max(torch.abs(g32)).reshape(1))
    q = torch.round(g32 / scale * (2.0 ** k)).to(torch.int32)
    return q, scale


def _dequantise(q: torch.Tensor, scale: torch.Tensor, k: int,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * (scale / (2.0 ** k))).to(dtype)


# elements of a leaf whose residual is computed at a time (float64 temporaries)
_RESIDUAL_CHUNK = 1 << 24


def _residual(fb: torch.Tensor, corrected: torch.Tensor, q: torch.Tensor,
              step: torch.Tensor) -> None:
    """``fb = corrected - q * step`` rounded once, as the reference's jitted
    step computes it: XLA duplicates the dequantising multiply into the
    subtraction's fusion, where it is contracted into an fma.  In float64
    the product (a 24-bit step times a code of k_planes + 1 bits) is exact
    for k_planes up to 28, and so is the difference (Sterbenz: corrected is
    within step/2 of q * step, or q is 0), so one cast to float32 gives the
    fma's rounding.  Differs from a float32 subtract only where the scale
    is not a power of two."""
    out, c, qq = fb.view(-1), corrected.reshape(-1), q.reshape(-1)
    s = step.to(torch.float64)
    for i in range(0, out.numel(), _RESIDUAL_CHUNK):
        sl = slice(i, i + _RESIDUAL_CHUNK)
        out[sl] = (c[sl].to(torch.float64)
                   - qq[sl].to(torch.float64) * s).to(torch.float32)


def compress_decompress(grads: Pytree, feedback: Pytree, k_planes: int
                        ) -> Tuple[Pytree, Pytree]:
    """Quantise -> dequantise with error feedback.  Returns (compressed
    grads, feedback), the feedback tensors updated in place."""
    def per_leaf(g, fb):
        corrected = g.to(torch.float32) + fb
        q, scale = _quantise(corrected, k_planes)
        deq = _dequantise(q, scale, k_planes, torch.float32)
        _residual(fb, corrected, q, scale / (2.0 ** k_planes))
        return deq.to(g.dtype)

    def sizes():
        return [(g.numel(), g.dtype) for g in tree_leaves(grads)]

    with torch.no_grad(), spans.span("compress", k_planes=k_planes,
                                     leaves=sizes):
        return tree_map(per_leaf, grads, feedback), feedback


def sum_safe_int_dtype(k_planes: int, n_ranks: int) -> torch.dtype:
    """Narrowest signed integer that holds Σ_{ranks} q_i without overflow:
    codes span ±2^k, the sum ±(n·2^k) — needs k + ceil(log2 n) + 1 bits."""
    bits = k_planes + math.ceil(math.log2(max(n_ranks, 2))) + 1
    if bits <= 7:
        return torch.int8
    if bits <= 15:
        return torch.int16
    return torch.int32


def _wire_codes(x: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """``round(x)`` converted to ``wire`` as XLA converts: NaN to 0, values
    out of range saturated."""
    info = torch.iinfo(wire)
    r = torch.round(x)
    r = torch.where(torch.isnan(r), 0.0, r)
    if wire != torch.int32:
        return r.clamp(info.min, info.max).to(wire)
    # 2^31 - 1 is no float32: clamp below it, then saturate the rest
    q = r.clamp(info.min, 2147483520.0).to(wire)
    return torch.where(r >= 2147483648.0, info.max, q)


def _pmax(amax: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's cross-rank max of a (1,) float32 amax (a NaN rank
    drops out), and a (1,) tensor > 0 where any rank's amax was NaN."""
    import torch.distributed as tdist
    nan = torch.isnan(amax)
    both = torch.cat([torch.where(nan, float("-inf"), amax),
                      nan.to(torch.float32)])
    tdist.all_reduce(both, op=tdist.ReduceOp.MAX, group=group)
    return both[:1], both[1:]


def _any_nan_rank(nan_rank) -> bool:
    """Whether ``_pmax`` saw a rank's NaN amax (a host read).  A fake
    tensor (a dry run's trace, ``launch/grad_sync_dryrun.py``) has no
    value to read: its trace takes the wire of finite gradients."""
    if nan_rank is None:
        return False
    from torch._subclasses.fake_tensor import is_fake
    return not is_fake(nan_rank) and bool(nan_rank > 0)


def _psum_codes(q: torch.Tensor, k: int, n: int, group, nan_rank
                ) -> Tuple[torch.Tensor, int]:
    """The sum of every rank's codes, in ``q``'s (wire) dtype, wrapped as
    the reference's sum wraps; and the bytes of the buffer handed to the
    all-reduce.  ``nan_rank`` (read only for an int16 wire) says whether a
    rank's amax was NaN."""
    import torch.distributed as tdist
    if q.dtype != torch.int16:
        out = q.clone()
        tdist.all_reduce(out, group=group)
        return out, out.numel() * out.element_size()
    flat = q.reshape(-1).to(torch.int32)
    if n << (k + 1) >= 1 << 16 or _any_nan_rank(nan_rank):
        tdist.all_reduce(flat, group=group)
        return flat.to(torch.int16).reshape(q.shape), flat.numel() * 4
    m = flat.numel()
    if m % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    # low lane: code + 2^k in [0, 2^(k+1)]; high lane: the signed code
    words = (flat[:half] + (1 << k)) + flat[half:] * 65536
    tdist.all_reduce(words, group=group)
    lo = words & 0xFFFF
    hi = (words - lo) >> 16
    sums = torch.cat([lo - n * (1 << k), hi])[:m]
    return sums.to(torch.int16).reshape(q.shape), half * 4


def compressed_psum(grads: Pytree, feedback: Pytree, k_planes: int,
                    axis: str, n_ranks: int = 0) -> Tuple[Pytree, Pytree]:
    """Data-parallel mean over the mesh dim ``axis`` of the mesh registered
    with ``models.dist.use_mesh``, moving top-k-bitplane integer codes
    instead of float32 (the wire is ``sum_safe_int_dtype(k_planes, n_ranks
    or 64)``); scales synchronise with a scalar max.  Returns (mean,
    feedback), the feedback tensors updated in place.  The bytes handed to
    the all-reduces (codes and amax) are left in
    ``compressed_psum.buffer_bytes``."""
    from repro_torch.models import dist
    mesh = dist._CTX["mesh"]
    if mesh is None:
        raise RuntimeError("compressed_psum needs a mesh: register one with "
                           "repro_torch.models.dist.use_mesh(mesh)")
    return _compressed_mean(grads, feedback, k_planes, n_ranks,
                            mesh.get_group(axis))


compressed_psum.buffer_bytes = 0


def _compressed_mean(grads: Pytree, feedback: Pytree, k_planes: int,
                     n_ranks: int, group) -> Tuple[Pytree, Pytree]:
    """:func:`compressed_psum` over ``group``; with ``group=None`` its
    one-process form (the sum is the rank's own codes, n = 1)."""
    import torch.distributed as tdist
    n = 1 if group is None else tdist.get_world_size(group)
    wire = sum_safe_int_dtype(k_planes, n_ranks or 64)
    compressed_psum.buffer_bytes = 0

    def per_leaf(g, fb):
        corrected = g.to(torch.float32) + fb
        amax = torch.max(torch.abs(corrected)).reshape(1)
        nan_rank = None
        if n > 1:
            amax, nan_rank = _pmax(amax, group)
        scale = _scale_of(amax)
        q = _wire_codes(corrected / scale * (2.0 ** k_planes), wire)
        if group is None:
            q_sum = q
        else:
            q_sum, nbytes = _psum_codes(q, k_planes, n, group, nan_rank)
            compressed_psum.buffer_bytes += nbytes + (8 if n > 1 else 0)
        step = scale / (2.0 ** k_planes)
        # XLA makes the reference's division by n a multiply by float32
        # 1/n (not exact for n = 3); a 0-d tensor keeps that float32 value
        mean = q_sum.to(torch.float32) * step * torch.tensor(
            np.float32(1) / np.float32(n), device=g.device)
        _residual(fb, corrected, q, step)
        return mean.to(g.dtype)

    with torch.no_grad():
        return tree_map(per_leaf, grads, feedback), feedback


def payload_bytes(grads: Pytree, k_planes: int) -> int:
    """Collective payload of one compressed all-reduce (k+1 bits/element,
    sign included) vs 32-bit floats."""
    n = sum(int(g.numel()) for g in tree_leaves(grads))
    return (n * (k_planes + 1) + 7) // 8
