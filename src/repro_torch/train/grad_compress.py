"""Bitplane gradient compression with error feedback.

Counterpart of ``repro/train/grad_compress.py``: per leaf, gradients are
quantised to the top ``k_planes`` bitplanes of a shared power-of-two
exponent (int32 codes), dequantised, and the residual fed back into the
next step's gradient.  ``compressed_psum`` (the data-parallel mean over a
process group) waits for the multi-device slice.

The shared exponent is ``ceil(log2(max(amax, 1e-30)))`` and the scale
``exp2(e)``, in float32, which jax lowers to ``log(x) / log(2)`` and
``exp(ln2 * e)``; the port computes those, not ``torch.log2`` and
``torch.exp2``.  So the reference's scale is not a power of two for most
exponents outside [-12, 12] (XLA's ``exp`` of ``ln2 * e`` is not exact),
and neither is the port's.  XLA's float32 ``log`` and ``exp`` are one ulp
off torch's on some inputs, so at a few amax values beside a power of two,
and at e = 32, the two scales differ (fault C6, ROADMAP;
``tests/test_torch_train.py`` lists them).

Unlike the reference, :func:`compress_decompress` writes the new residuals
into the feedback tensors it is given and returns them (one fp32 copy of
the model's size saved at every step).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.train.pytree import tree_leaves, tree_map

Pytree = Any

LN2 = 0.6931471824645996      # float32(ln 2), jax's constant for both


def zeros_like_feedback(grads: Pytree) -> Pytree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quantise(g: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int32 codes in [-2^k, 2^k], power-of-two scale)."""
    g32 = g.to(torch.float32)
    amax = torch.max(torch.abs(g32))
    # jax lowers log2(x) to log(x) / log(2) and exp2(e) to exp(ln2 * e)
    ln2 = torch.tensor(LN2, dtype=torch.float32, device=g.device)
    e = torch.ceil(torch.log(torch.clamp_min(amax, 1e-30)) / ln2)
    scale = torch.exp(ln2 * e)
    q = torch.round(g32 / scale * (2.0 ** k)).to(torch.int32)
    return q, scale


def _dequantise(q: torch.Tensor, scale: torch.Tensor, k: int,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * (scale / (2.0 ** k))).to(dtype)


def compress_decompress(grads: Pytree, feedback: Pytree, k_planes: int
                        ) -> Tuple[Pytree, Pytree]:
    """Quantise -> dequantise with error feedback.  Returns (compressed
    grads, feedback), the feedback tensors updated in place."""
    def per_leaf(g, fb):
        corrected = g.to(torch.float32) + fb
        q, scale = _quantise(corrected, k_planes)
        deq = _dequantise(q, scale, k_planes, torch.float32)
        fb.copy_(corrected - deq)
        return deq.to(g.dtype)

    with torch.no_grad():
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


def payload_bytes(grads: Pytree, k_planes: int) -> int:
    """Collective payload of one compressed all-reduce (k+1 bits/element,
    sign included) vs 32-bit floats."""
    n = sum(int(g.numel()) for g in tree_leaves(grads))
    return (n * (k_planes + 1) + 7) // 8
