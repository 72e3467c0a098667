"""experts_roofline.decode: the MoE expert products' share of their
roofline, in percent: the least time (``perfbench.work.min_seconds``) of
the work that each ``repro_torch.experts`` span's kept (token, slot) pairs
need, summed, over the spans' summed device time (their CUDA events).  A
span with n kept pairs over u distinct experts needs 6·d·d_ff·n FLOPs, and
the u experts' three weight matrices read once, u·3·d·d_ff elements of the
weights' dtype, with each kept pair's row read and written once, 2·n·d
elements of the activations' dtype.  ``None`` where the program records no
such span on the card."""
import torch

from perfbench import work

SPAN = "repro_torch.experts"


def pairs(attrs):
    """(kept pairs, experts with at least one kept pair) of one span: the
    dispatch's mask of kept pairs (the onehot dispatch's with a trailing
    expert dim) and each pair's expert."""
    kept, expert = attrs["kept"], attrs["expert"]
    if kept.dim() > expert.dim():
        kept = kept.any(-1)
    return int(kept.sum()), int(torch.unique(expert[kept]).numel())


def least(attrs) -> dict:
    n, used = pairs(attrs)
    d, f = attrs["d"], attrs["d_ff"]
    wb = getattr(torch, attrs["weights"]).itemsize
    ab = getattr(torch, attrs["dtype"]).itemsize
    return {"flops": 6.0 * d * f * n,
            "bytes": float(used * 3 * d * f * wb + 2 * n * d * ab)}


def _records(view):
    try:
        from repro_torch import spans
    except ImportError:         # a program that records no spans
        return []
    return [r for r in spans.records() if r.name == SPAN and
            r.device_ms is not None and view.lo <= r.t0 and r.t1 <= view.hi]


def read(view):
    if view.kind != "decode":
        return None
    recs = _records(view)
    device_s = sum(r.device_ms for r in recs) / 1e3
    if not device_s:
        return None
    return 100.0 * sum(work.min_seconds(least(r.attrs))
                       for r in recs) / device_s
