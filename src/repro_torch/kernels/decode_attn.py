"""Single-token decode attention over a KV cache, split over its slots.

No Pallas kernel of the reference computes this: its decode attention is
the jnp graph ``repro/models/layers.py:127`` (``gqa_attend``), which the
port runs as ``models.layers._gqa_attend``.  Over a cache (B, T, K, hd)
that path copies every layer's whole K and V to a contiguous layout and
computes float64 scores over all T slots, masked ones included, at every
step.  On the card, :func:`decode_attn` launches instead the hand-written
split-KV kernel ``decode_attn`` of ``csrc/decode_attn.cu`` (its note says
what bounds it and how it is built), which reads the cache where it lies
and only over the slots the mask admits.

:func:`admits` is the only test of which path runs: ``attention_decode``
takes the kernel exactly where it holds (plain CUDA tensors, so no DTensor
and no fake tensor, a cache of a type and a head shape in
:data:`INSTANCES`), and keeps ``gqa_attend`` everywhere else: the CPU,
sharded caches, the int8 cache, the reduced test shapes.
:func:`decode_attn` launches the kernel or raises; it never reads ``pos``
on the host, so a step makes no sync.  Its checks, its scratch and its
packed arguments are made once per shape, thread and stream, so that a
call costs the host one output allocation, the pointers and the launch.

:func:`decode_attn_plain` is the same split-and-combine arithmetic in plain
torch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

# (cache dtype, hd, query heads per KV head) of every full-size
# configuration in ``repro_torch.configs`` that decodes through
# ``attention_decode``; ``csrc/decode_attn.cu`` instances exactly these
INSTANCES = frozenset({
    (torch.bfloat16, 64, 1),      # seamless-m4t-medium
    (torch.bfloat16, 80, 1),      # zamba2-2.7b
    (torch.bfloat16, 96, 1),      # phi-3-vision-4.2b
    (torch.bfloat16, 128, 1),     # olmoe-1b-7b
    (torch.bfloat16, 128, 2),     # internlm2-1.8b
    (torch.bfloat16, 128, 5),     # qwen2.5-14b, llama4-maverick
    (torch.bfloat16, 128, 16),    # glm4-9b
    (torch.bfloat16, 256, 4),     # gemma3-1b
})
_DTYPE_CODES = {torch.bfloat16: 0}

# blocks a launch aims at: many times the 132 SMs' resident blocks
TARGET_BLOCKS = 4096
# a split's slots are a multiple of every instance's tile (64 or 32 slots)
SPLIT_ALIGN = 64

# the plain path's masked score: float32 -1e30, widened
_NEG = float(np.float32(-1e30))


def admits(q: torch.Tensor, cache_k: torch.Tensor,
           cache_v: torch.Tensor) -> bool:
    """Whether decode attention of ``q`` (B, 1, H, hd) over the caches
    (B, T, K, hd) runs the kernel: CUDA tensors that are not DTensors, of
    one type, with a (cache dtype, hd, group) in :data:`INSTANCES`."""
    if not (q.is_cuda and cache_k.is_cuda and cache_v.is_cuda):
        return False
    if not type(q) is type(cache_k) is type(cache_v) is torch.Tensor:
        return False            # a DTensor, or another tensor subclass
    kv, h = cache_k.shape[2], q.shape[2]
    group = h // kv if kv and h % kv == 0 else 0
    return (q.dtype == cache_k.dtype == cache_v.dtype and
            (cache_k.dtype, q.shape[-1], group) in INSTANCES)


@functools.lru_cache(maxsize=None)
def split_plan(bk: int, t: int) -> Tuple[int, int]:
    """(n_split, slots a split) for B·K = ``bk`` (row, KV head) pairs over
    ``t`` cache slots: about TARGET_BLOCKS blocks, each split a whole
    number of tiles.  Shapes alone decide it, never ``pos``."""
    want = min(-(-TARGET_BLOCKS // bk), -(-t // SPLIT_ALIGN))
    chunk = -(-(-(-t // want)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-t // chunk), chunk


def window_bounds(pos: int, t: int, window: int) -> Tuple[int, int, bool]:
    """The slots [lo, hi) that the decode mask admits at ``pos`` over
    ``t`` slots (``window`` > 0 on a local layer), and whether it admits
    none: the plain path's softmax is then uniform over all ``t`` slots,
    which (0, t, True) stands for."""
    hi = min(pos + 1, t)
    lo = max(0, pos - window + 1) if window > 0 else 0
    if lo >= hi:
        return 0, t, True
    return lo, hi, False


def _window(is_local: bool, window: int) -> int:
    return window if is_local and window > 0 else 0


def decode_attn_plain(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos, is_local: bool,
                      window: int, n_split: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (``n_split`` 0: the kernel's
    own plan): per split, q·k in float32, each score widened to float64
    and divided by sqrt(hd), max, exp and sum in float64, P·V in float32
    with each probability rounded once to float32; then the live splits
    merged in float64 and the output rounded once to the cache's type.
    q (B, 1, H, hd) -> (B, 1, H, hd).  Reads ``pos`` on the host."""
    b, _, h, hd = q.shape
    t, kv = cache_k.shape[1], cache_k.shape[2]
    g = h // kv
    if n_split:
        chunk = -(-t // n_split)
    else:
        _, chunk = split_plan(b * kv, t)
    lo, hi, uniform = window_bounds(int(pos), t, _window(is_local, window))
    sqrt_hd = math.sqrt(hd)
    qf = q.reshape(b, kv, g, hd).to(torch.float32)
    ms, ls, accs = [], [], []
    for s in range(lo // chunk, (hi - 1) // chunk + 1):
        a, e = max(s * chunk, lo), min((s + 1) * chunk, hi)
        kf = cache_k[:, a:e].to(torch.float32)
        vf = cache_v[:, a:e].to(torch.float32)
        if uniform:
            sd = torch.full((b, kv, g, e - a), _NEG, dtype=torch.float64,
                            device=q.device)
        else:
            dot = torch.einsum("bkgd,bnkd->bkgn", qf, kf)
            sd = dot.to(torch.float64) / sqrt_hd
        m = sd.amax(-1)
        p = torch.exp(sd - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgn,bnkd->bkgd", p.to(torch.float32), vf))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    lsum = (torch.stack(ls) * w).sum(0)
    out = (torch.stack(accs).to(torch.float64) * w[..., None]).sum(0)
    out = out / lsum[..., None]
    return out.to(cache_k.dtype).reshape(b, 1, h, hd)


class _Params(ctypes.Structure):
    """One call's arguments, as ``struct Params`` of the source."""
    _fields_ = [("q", ctypes.c_void_p), ("ck", ctypes.c_void_p),
                ("cv", ctypes.c_void_p), ("pos", ctypes.c_void_p),
                ("part_ml", ctypes.c_void_p), ("part_acc", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("sqrt_hd", ctypes.c_double)] + [
        (f, ctypes.c_int) for f in ("batch", "nslots", "kv_heads", "group",
                                    "hd", "dtype", "window", "n_split",
                                    "chunk")]


def pack(q, cache_k, cache_v, pos, window: int, part_ml: int, part_acc: int,
         out: int) -> _Params:
    """The kernel's arguments, the scratch and the output given by address
    (``window`` 0 on a global layer)."""
    b, _, h, hd = q.shape
    t, kv = cache_k.shape[1], cache_k.shape[2]
    n_split, chunk = split_plan(b * kv, t)
    return _Params(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                   pos.data_ptr(), part_ml, part_acc, out, math.sqrt(hd), b,
                   t, kv, h // kv, hd, _DTYPE_CODES[cache_k.dtype], window,
                   n_split, chunk)


_ready = set()      # (device, dtype, hd, group) allowed its shared memory


def library(device: int, dtype: torch.dtype, hd: int, group: int):
    """The loaded library, its instance for (dtype, hd, group) set up on
    CUDA device ``device``."""
    lib = build.load("decode_attn")
    key = (device, dtype, hd, group)
    if key not in _ready:
        with torch.cuda.device(device):
            build.check(lib.decode_attn_setup(_DTYPE_CODES[dtype], hd, group),
                        "decode_attn_setup")
        _ready.add(key)
    return lib


class _Plan:
    """What the calls of one shape share, on one thread and stream: the
    checks of everything but the pointers, made once; the packed arguments,
    of which a call sets only the pointers; and the scratch, which the
    stream's order keeps from one call to the next."""

    def __init__(self, q, cache_k, cache_v, pos, window: int, stream: int):
        if not admits(q, cache_k, cache_v):
            raise ValueError(
                f"decode_attn: no kernel for q {tuple(q.shape)} {q.dtype} "
                f"on {q.device}, cache {tuple(cache_k.shape)} "
                f"{cache_k.dtype}")
        b, s, h, hd = q.shape
        if s != 1:
            raise ValueError(f"decode_attn: q must be (B, 1, H, hd), got "
                             f"{tuple(q.shape)}")
        shape = cache_k.shape
        if cache_v.shape != shape or shape[0] != b or shape[3] != hd:
            raise ValueError(f"decode_attn: caches {tuple(shape)} and "
                             f"{tuple(cache_v.shape)} do not fit q "
                             f"{tuple(q.shape)}")
        dev = q.device
        if not cache_k.device == cache_v.device == pos.device == dev or \
                pos.dtype != torch.int32 or pos.numel() != 1:
            raise ValueError(f"decode_attn: caches and pos (one int32) must "
                             f"be on {dev}, got {cache_k.device}, "
                             f"{cache_v.device}, pos {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        t, kv = shape[1], shape[2]
        n_split, _ = split_plan(b * kv, t)
        rows = b * h * n_split
        # (rows, 2) float64 (max, sum) then (rows, hd) float32
        self.scratch = torch.empty(rows * (4 + hd), dtype=torch.float32,
                                   device=dev)
        part = self.scratch.data_ptr()
        self.params = pack(q, cache_k, cache_v, pos, window, part,
                           part + 16 * rows, 0)
        self.address = ctypes.addressof(self.params)
        self.fn = library(dev.index, cache_k.dtype, hd, h // kv).decode_attn
        self.index, self.stream = dev.index, stream
        self.out = dict(size=(b, 1, h, hd), dtype=cache_k.dtype, device=dev)

    def __call__(self, q, cache_k, cache_v, pos) -> torch.Tensor:
        for c in (cache_k, cache_v):
            if not c.is_contiguous() or c.data_ptr() % 16:
                raise ValueError("decode_attn: the caches must be contiguous "
                                 "and 16-B aligned")
        if not q.is_contiguous():
            q = q.contiguous()
        out = torch.empty(**self.out)
        p = self.params
        p.q, p.ck, p.cv = q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr()
        p.pos, p.out = pos.data_ptr(), out.data_ptr()
        if torch.cuda.current_device() == self.index:
            status = self.fn(self.address, self.stream)
        else:
            with torch.cuda.device(self.index):
                status = self.fn(self.address, self.stream)
        build.check(status, "decode_attn")
        decode_attn.launches += 2
        return out


_plans = {}


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, is_local: bool,
                window: int) -> torch.Tensor:
    """Decode attention of ``q`` (B, 1, H, hd), after RoPE, over the caches
    (B, T, K, hd) at the 0-d int32 device tensor ``pos``, as
    ``gqa_attend(q, cache_k, cache_v, gqa_scores_mask(pos, arange(T),
    is_local, window))`` computes it: (B, 1, H, hd) in the cache's type.
    Enqueues the kernel and its combine pass on the current stream (two
    launches, counted in ``decode_attn.launches``); raises where
    :func:`admits` does not hold."""
    index = q.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index) if index >= 0 else 0
    win = _window(is_local, window)
    key = (threading.get_ident(), stream, win, q.shape, q.dtype, type(q),
           cache_k.shape, cache_k.dtype, type(cache_k), cache_k.get_device(),
           cache_v.shape, cache_v.dtype, type(cache_v), cache_v.get_device(),
           pos.shape, pos.dtype, pos.get_device())
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _Plan(q, cache_k, cache_v, pos, win, stream)
    return plan(q, cache_k, cache_v, pos)


decode_attn.launches = 0
