"""Collective and dot profiler for one dry-run cell: groups the per-device
collective bytes by (kind, shape) and the dot FLOPs by shape, so the
dominant contributor is obvious.

Counterpart of ``repro/launch/diag.py``::

    PYTHONPATH=src python -m repro_torch.launch.diag --arch X --shape Y \
        [--mesh single|multipod] [--device cpu] [--save trace.txt]

The reference groups the partitioned HLO's instructions, each scaled by
its loop's trip count.  The port groups the op records of the traced step
(``launch/hlo_analysis.py``): one record per execution, so a group's count
is the reference's trip multiplier times its instructions, and "in" names
the aten or collective op where the reference names the computation.
``--save`` writes that op trace (one op a line), not HLO.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Iterable, List, Tuple

from repro_torch.launch.hlo_analysis import OpRecord


def profile_collectives(records: Iterable[OpRecord], top: int = 15
                        ) -> List[Tuple]:
    groups = defaultdict(lambda: [0.0, 0])
    for r in records:
        if r.collective:
            g = groups[(r.collective, r.shape[:70], r.op[:40])]
            g[0] += r.out_bytes
            g[1] += 1
    rows = sorted(((b, m, op, shape, name)
                   for (op, shape, name), (b, m) in groups.items()),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"total collective bytes/dev: {total:.3e}")
    for b, m, op, shape, name in rows[:top]:
        print(f"  {b:10.3e}B ({b / max(total, 1):5.1%}) x{m:<5.0f} {op:20s} "
              f"{shape} in {name}")
    return rows


def profile_dots(records: Iterable[OpRecord], top: int = 10) -> List[Tuple]:
    groups = defaultdict(lambda: [0.0, 0])
    for r in records:
        if r.flops:
            g = groups[(r.shape[:60], r.op[:40])]
            g[0] += r.flops
            g[1] += 1
    rows = sorted(((f, m, shape, name)
                   for (shape, name), (f, m) in groups.items()),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"total dot flops/dev: {total:.3e}")
    for f, m, shape, name in rows[:top]:
        print(f"  {f:10.3e} ({f / max(total, 1):5.1%}) x{m:<5.0f} {shape} "
              f"in {name}")
    return rows


def save_trace(records: Iterable[OpRecord], path: str) -> None:
    """One line per op: name, output shapes, output bytes, dot FLOPs,
    collective kind."""
    with open(path, "w") as f:
        for r in records:
            f.write(f"{r.op}\t{r.shape}\t{r.out_bytes}\t{r.flops:.0f}\t"
                    f"{r.collective or '-'}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod"])
    ap.add_argument("--save", default="")
    ap.add_argument("--moe-dispatch", default="scatter")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_cell, production_meshes

    mesh = production_meshes([args.mesh], args.device)[args.mesh]
    records: List[OpRecord] = []
    stats = lower_cell(args.arch, args.shape, mesh,
                       moe_dispatch=args.moe_dispatch, device=args.device,
                       records=records)
    print(f"status={stats['status']} trace={stats.get('trace_s')}s")
    if args.save:
        save_trace(records, args.save)
    print("== collectives ==")
    profile_collectives(records)
    print("== dots ==")
    profile_dots(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
