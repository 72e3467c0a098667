"""attn_roofline.decode: the decode attention's share of its roofline, in
percent: the least time (``perfbench.work.min_seconds``) of the work that
each ``repro_torch.attend`` span's inputs need, summed, over the spans'
summed device time (their CUDA events).  A span over valid = min(pos + 1,
T) cache slots a row needs 4·hd·H·B·valid FLOPs, and each valid K and V
slot read once: 2·B·valid·K·hd elements of the cache's dtype, and for an
int8 cache 2·B·valid·K float32 scales.  ``None`` where the program records
no such span on the card."""
import torch

from perfbench import work

SPAN = "repro_torch.attend"


def least(attrs) -> dict:
    a = attrs
    valid = min(a["pos"] + 1, a["T"])
    slots = 2 * a["B"] * valid * a["K"]
    nbytes = slots * a["hd"] * getattr(torch, a["cache"]).itemsize
    if a["cache"] == "int8":
        nbytes += slots * 4
    return {"flops": 4.0 * a["hd"] * a["H"] * a["B"] * valid,
            "bytes": float(nbytes)}


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
