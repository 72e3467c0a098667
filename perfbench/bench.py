"""The harness: a cell found by name, run from a seed, measured, traced,
checked against the reference, and reported.

Everything of a cell is found by name from ``BENCHMARK.json``:
``perfbench/workloads/<cell>.json`` (the traffic: its ``kind``, its
parameters and the limits of its check), the configuration file the
benchmark names for the cell's ``config`` (with its ``layout``, the
reference's module in ``perfbench/reference/layouts``, by default its
family), ``perfbench/drivers/<kind>.py``
(the window loop of a kind) and ``perfbench/metrics/<metric>.py`` (one
reader per per-layer metric).  Adding a cell, a configuration or a metric
adds files and edits none.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from perfbench import trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json``: its workload file, its configuration
    file and the metrics it reports."""
    name: str
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list

    def model_config(self):
        from repro_torch.models.config import ModelConfig
        return ModelConfig(**{k: v for k, v in self.config.items()
                              if k != "layout"})


def _reported(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, manifest: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    manifest = manifest or load_json(root / "BENCHMARK.json")
    entry = next(w for w in manifest["workloads"] if w["name"] == name)
    conf = next(c for c in manifest["configs"]
                if c["name"] == entry["config"])
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    data = load_json(root / conf["file"])
    config = dict(data["config"])
    if "layout" in data:
        config["layout"] = data["layout"]
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reported(m, name, names)]
    return Cell(name, workload, config, e2e, per_layer)


def driver_for(cell: Cell, seed: int, device, fault: str = ""):
    mod = importlib.import_module(f"perfbench.drivers.{cell.workload['kind']}")
    return mod.Driver(cell, seed, device, fault)


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: dict, limits: dict, prefix: str = ""
          ) -> Tuple[bool, dict]:
    """The check: every number compared at or under its limit.  Returns
    (correct, {name: {"value", "limit"}}); ``prefix`` reads another
    side's numbers under the same limits (``control_`` for the fp8
    control's).  A number that is missing or not finite fails."""
    checks = {k: {"value": readings.get(prefix + k, math.inf),
                  "limit": limit} for k, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def _value(x: float, unit: str) -> dict:
    return {"value": x, "unit": unit}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, fault: str = "") -> dict:
    """Set up, warm up, measure ``seconds``, read the trace when
    ``traced``, free the program's state, check against the reference.
    Returns the result line's fields (``device`` holding what the run
    read of the card), the numbers compared and their limits last, under
    ``checks``."""
    drv = driver_for(cell, seed, device, fault)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    if traced:
        with trace.Recorder(device) as rec:
            res = drv.window(seconds)
        view = rec.view(kind=drv.kind, steps=res["steps"],
                        window_s=res["window_s"], step_work=drv.step_work())
        metrics = {}
        for m in cell.per_layer:
            val = metric_reader(m["name"])(view)
            if val is not None:
                metrics[m["name"]] = _value(val, m["unit"])
        breakdown = view.breakdown()
        extra = {"busy_s": view.busy_s, "window_s": view.trace_s}
        del rec, view
    else:
        res = drv.window(seconds)
        metrics = {"setup_s": _value(setup_s, "s")}
        for m in cell.end_to_end:
            if m["name"] in res:
                metrics[m["name"]] = _value(res[m["name"]], m["unit"])
        breakdown, extra = None, {}
    failed = drv.failed() if hasattr(drv, "failed") else 0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.readings()
    limits = cell.workload["limits"]
    correct, checks = judge(readings, limits)
    correct = correct and failed == 0
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": failed, "metrics": metrics,
           "device": {"memory_peak_bytes": peak, **extra},
           "steps": res["steps"], "counts": {
               k: v for k, v in readings.items() if k not in limits}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
