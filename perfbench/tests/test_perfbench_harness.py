"""The harness on the CPU at the configurations' reduced sizes: the plain
reference against the program for decode and for training steps, the
faults planted in the timed path that ``correct`` must catch, the fp8
control failing the harness's own check, and the trace's choice of the
device's operations."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import bench  # noqa: E402
from repro_torch import configs  # noqa: E402

CPU = torch.device("cpu")
SEED = 3_456_789_012_345     # wider than 32 bits, as the driver's are

DECODE = dict(kind="decode", batch=4, context=16, max_seq=24,
              warmup_steps=2, k_scale=3.0, v_scale=1.0, limits={"gap": 1e-3})
TRAIN = dict(kind="train", batch=2, seq=16, ring=4, zipf_s=1.1, lr=3e-3,
             max_grad_norm=1.0, k_planes=8, checked_steps=3,
             limits={"loss1_gap": 1e-4, "grad_gap": 1e-4, "grad_diff": 1e-2,
                     "change_gap": 1e-3})


def tiny_cell(arch: str, workload: dict, name: str = "", **cfg
              ) -> bench.Cell:
    config = dataclasses.asdict(configs.get_reduced(arch))
    config.update(cfg)
    name = name or {"decode": "internlm2-decode-32k",
                    "train": "internlm2-train-4k"}[workload["kind"]]
    full = bench.load_cell(name)
    return bench.Cell(name, dict(workload), config, full.end_to_end,
                      full.per_layer)


def run(cell: bench.Cell, traced: bool = False, fault: str = "") -> dict:
    return bench.run_cell(cell, SEED, 0.2, traced, CPU, time.perf_counter(),
                          fault=fault)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
@pytest.mark.parametrize("traced", [False, True])
def test_decode_agrees_with_the_reference(arch, traced):
    out = run(tiny_cell(arch, DECODE), traced)
    assert out["correct"], out["checks"]
    assert out["checks"]["gap"]["value"] == 0.0
    names = {m["name"] for m in (bench.load_cell("internlm2-decode-32k")
                                 .per_layer if traced else
                                 bench.load_cell("internlm2-decode-32k")
                                 .end_to_end)}
    assert set(out["metrics"]) <= names | {"setup_s"}
    assert out["attempted"] == out["steps"] * DECODE["batch"]


def test_moe_decode_agrees_where_capacity_drops_tokens():
    """64 rows of 2-of-8 routing over a capacity of 24 a step: experts
    overflow, and the reference drops the same (token, slot) pairs."""
    wl = dict(DECODE, batch=64, context=8, max_seq=14)
    out = run(tiny_cell("olmoe-1b-7b", wl))
    assert out["correct"], out["checks"]
    assert out["counts"]["dropped"] > 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_train_steps_agree_with_the_reference(arch):
    out = run(tiny_cell(arch, TRAIN))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == out["steps"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("internlm2-decode-32k", "stale_state"),
    ("internlm2-decode-32k", "half_batch"),
    ("internlm2-decode-32k", "token"),
    ("internlm2-train-4k", "stale_state"),
    ("internlm2-train-4k", "half_batch"),
    ("internlm2-train-4k", "answer"),
    ("olmoe-decode-4k", "stale_state"),
    ("olmoe-decode-4k", "half_batch")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """Each fault a cell can have, planted under the rest of a run at the
    reduced size, fails the cell's own limits.  (One token altered among
    olmoe-decode-4k's is below its mean gap's reach: internlm2-decode-32k
    catches it on the same decode path.)"""
    full = bench.load_cell(cell)
    wl = DECODE if full.workload["kind"] == "decode" else TRAIN
    out = run(tiny_cell(full.config["name"],
                        dict(wl, limits=full.workload["limits"]), cell),
              fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("arch,kind", [("internlm2-1.8b", "decode"),
                                       ("olmoe-1b-7b", "decode"),
                                       ("internlm2-1.8b", "train")])
def test_the_fp8_control_fails_the_harness_s_check(arch, kind):
    """The fp8 control's readings, at the same positions and steps as the
    program's, through the harness's own check: the program passes and
    the control fails, under the test's limits (decode) and under the
    train cell's own."""
    from perfbench.drivers import decode, train
    mod, wl = (decode, DECODE) if kind == "decode" else (train, TRAIN)
    if kind == "train":
        wl = dict(wl, limits=bench.load_cell("internlm2-train-4k")
                  .workload["limits"])
    drv = mod.Driver(tiny_cell(arch, wl), SEED, CPU)
    drv.setup()
    drv.window(0.05)
    drv.release()
    got = drv.readings(control=True)
    assert bench.judge(got, wl["limits"])[0], got
    ok, checks = bench.judge(got, wl["limits"], "control_")
    assert not ok, checks


class _Event:
    """A profiler event as ``trace.split`` reads it."""

    def __init__(self, name, start, end, device, kind):
        self._n, self._s, self._e, self._d, self._k = name, start, end, \
            device, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._d)

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")


class _EventOfNoKind(_Event):
    """An event of a profiler that gives no activity kind (torch 2.11)."""

    activity_type = None


@pytest.mark.parametrize("_Event", [_Event, _EventOfNoKind])
def test_an_annotation_inside_the_step_moves_no_reading(_Event):
    """A ``record_function`` range in the program shows on the device as a
    ``gpu_user_annotation``: it is no launch, and it fills no idle gap."""
    from perfbench import trace
    base = [_Event(trace._WINDOW, 0, 1000, "CPU", "user_annotation"),
            _Event("aten::mm", 5, 40, "CPU", "cpu_op"),
            _Event("gemm_kernel", 10, 100, "CUDA", "kernel"),
            _Event("Memcpy DtoH", 400, 450, "CUDA", "gpu_memcpy"),
            _Event("Memset", 460, 470, "CUDA", "gpu_memset"),
            _Event("elementwise_kernel", 600, 700, "CUDA", "kernel"),
            _Event("cudaLaunchKernel", 8, 9, "CPU", "cuda_runtime")]
    spans = [_Event("attention_decode", 0, 1000, "CUDA",
                    "gpu_user_annotation"),
             _Event("attention_decode", 1, 999, "CPU", "user_annotation")]
    views = [trace.View(*trace.split(events), kind="decode", steps=2,
                        window_s=1e-6, step_work={})
             for events in (base, base + spans)]
    for v in views:
        assert len(v.kernels()) == 2 and v.busy_s == pytest.approx(
            (90 + 50 + 10 + 100) / 1e9)
        assert v.class_seconds() == pytest.approx(
            {"matmul": 90e-9, "copy": 50e-9, "elementwise": 110e-9})
    assert views[0].idle_share() == views[1].idle_share() == \
        pytest.approx(0.75)
    assert views[0].breakdown()["device_ops"] == \
        views[1].breakdown()["device_ops"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_short_decode_run_on_the_card(cuda_device):
    out = bench.run_cell(tiny_cell("internlm2-1.8b", DECODE), SEED, 0.5,
                         True, cuda_device, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
