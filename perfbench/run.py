#!/usr/bin/env python3
"""Run one cell of the benchmark on the card(s) of this machine.

    python3 perfbench/run.py --workload internlm2-decode-32k --seed 7 \\
        --seconds 35 --trace 0

From the root of a checkout: load, warm up, measure for ``--seconds``, free
the program's state, check what the timed path produced against the plain
reference, and print one JSON line last (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; ``breakdown`` with ``--trace 1``; the
numbers compared beside their limits under ``checks``, last).  With
``--trace 0`` the metrics are the cell's end-to-end ones, with ``--trace 1``
its per-layer ones, read from ``torch.profiler`` over the window.

Every build and kernel cache lives under ``build/`` in the checkout.
Exits non-zero, printing no result, without enough CUDA devices, when the
program is absent, or when the JAX package or JAX itself was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the script's own folder is no import root: its module names (trace,
# bench, ...) would shadow others
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
          "CUDA_CACHE_PATH": "build/nv_cache"}
# top-level modules the process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _environment() -> None:
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _card_name_and_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from perfbench import bench
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    chips = next(w["chips"] for w in bench.load_json(
        ROOT / "BENCHMARK.json")["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)  # the allocator's stats exist from here
    torch.cuda.reset_peak_memory_stats(device)
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(device),
                     "count": chips, **out["device"],
                     "card": _card_name_and_limit()}
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
