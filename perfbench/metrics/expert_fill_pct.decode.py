"""expert_fill_pct.decode: the share, in percent, of the rows that the MoE
expert products compute that hold a routed token: the kept (token, slot)
pairs of every ``repro_torch.experts`` span in the window over its E·C
queue rows (a program counter: the dispatch's own mask).  ``None`` where
the program records no such span."""

SPAN = "repro_torch.experts"


def _records(view):
    try:
        from repro_torch import spans
    except ImportError:         # a program that records no spans
        return []
    return [r for r in spans.records() if r.name == SPAN and
            view.lo <= r.t0 and r.t1 <= view.hi]


def read(view):
    if view.kind != "decode":
        return None
    recs = _records(view)
    rows = sum(r.attrs["E"] * r.attrs["C"] for r in recs)
    if not rows:
        return None
    return 100.0 * sum(int(r.attrs["kept"].sum()) for r in recs) / rows
