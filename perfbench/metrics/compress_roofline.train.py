"""compress_roofline.train: the gradient compressor's share of its
roofline, in percent: the least time (``perfbench.work.min_seconds``) of
the bytes that each ``repro_torch.compress`` span's leaves need, summed,
over the spans' summed device time (their CUDA events).  A leaf of n
elements needs its gradient read and its compressed gradient written, and
its float32 feedback read and written once: n·(2·grad bytes + 8).
``None`` where the program records no such span on the card."""
import torch

from perfbench import work

SPAN = "repro_torch.compress"


def least(attrs) -> dict:
    nbytes = sum(n * (2 * getattr(torch, g).itemsize + 8)
                 for n, g in attrs["leaves"])
    return {"flops": 0.0, "bytes": float(nbytes)}


def _records(view):
    try:
        from repro_torch import spans
    except ImportError:         # a program that records no spans
        return []
    return [r for r in spans.records() if r.name == SPAN and
            r.device_ms is not None and view.lo <= r.t0 and r.t1 <= view.hi]


def read(view):
    if view.kind != "train":
        return None
    recs = _records(view)
    device_s = sum(r.device_ms for r in recs) / 1e3
    if not device_s:
        return None
    return 100.0 * sum(work.min_seconds(least(r.attrs))
                       for r in recs) / device_s
