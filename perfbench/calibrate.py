#!/usr/bin/env python3
"""Read what the limits of a cell's check are set from, in one process:
the program's readings over many seeds (each a set-up, a window of the
cell's own load, the reference), the fp8 control's readings on some of
them, and the readings of faults planted in the timed path.

    python3 perfbench/calibrate.py --workload internlm2-decode-32k \\
        --seconds 35 --seeds 101 102 103 --control-seeds 101 102 103 \\
        --faults half_batch --out chiprun_out/calib.jsonl

Prints one JSON line a reading and appends it to ``--out``, with the
verdict of the harness's own check (``bench.judge``) under the cell's
limits: ``correct`` for the program's run or the fault's, and
``control_correct`` for the control's readings.  The benchmark's runs
never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seconds", type=float, default=0.0,
                    help="the faults' window (default: --seconds)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from perfbench import bench
    cell = bench.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(s, "") for s in args.seeds] + \
        [(s, f) for f in args.faults for s in args.fault_seeds]
    for seed, fault in runs:
        t0 = time.perf_counter()
        torch.empty(1, device=dev)  # the allocator's stats exist from here
        torch.cuda.reset_peak_memory_stats(dev)
        drv = bench.driver_for(cell, seed, dev, fault)
        drv.setup()
        res = drv.window(args.fault_seconds if fault and args.fault_seconds
                         else args.seconds)
        peak = torch.cuda.max_memory_allocated(dev)
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        control = not fault and seed in args.control_seeds
        readings = drv.readings(control=control)
        limits = cell.workload["limits"]
        verdicts = {"correct": bench.judge(readings, limits)[0]}
        if control:
            verdicts["control_correct"] = bench.judge(readings, limits,
                                                      "control_")[0]
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                **verdicts,
                "steps": res["steps"], "peak_bytes": peak,
                "run_s": t1 - t0, "check_s": time.perf_counter() - t1,
                **readings, **({"leaf_diff": drv.leaf_diff}
                               if hasattr(drv, "leaf_diff") else {})}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
