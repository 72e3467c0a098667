"""The traced window: ``torch.profiler`` over the whole window, read from
its raw events (no event tree is built), and the frozen table of kernel
classes that the per-layer readers use.

A ``View`` holds the device's operations in the window (kernels, copies
and sets, chosen by the profiler's activity kind and never by name, each
a name, an interval on the profiler's clock and its kind), the host's
operations, the window's bounds, the steps completed and the work of one
step (``perfbench.work``).  The readers in ``perfbench/metrics`` take a
``View`` and return a number, or ``None`` where they find nothing to
read.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# Kernel classes by name, the first match winning: a frozen copy of the
# classes of the program's profiling tools (tools/profile_train_step.py),
# with copies split off the elementwise class.  Matrix-product kernels are
# cuBLAS's and CUTLASS's (gemm, cutlass, sm90_, xmma, nvjet).
KERNEL_CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("matmul", ("gemm", "cutlass", "sm90_", "xmma", "nvjet")),
    ("copy", ("copy", "memcpy")),
    ("index", ("index", "scatter", "gather")),
    ("scan", ("scan", "cumsum", "cummax")),
    ("sort", ("sort", "radix")),
    ("reduce", ("softmax", "reduce", "norm")),
)


def class_of(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise"


_WINDOW = "perfbench.window"

# The profiler's activity kinds of the device operations that the readers
# see: kernels, copies and sets.  A ``record_function`` range shows on the
# device too, as a ``gpu_user_annotation``, and is none of them.
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}


def device_kind(event) -> Optional[str]:
    """The kind of a profiler event that is an operation on the device
    (``kernel``, ``memcpy`` or ``memset``), or ``None`` for a host event
    or an annotation's range."""
    if event.device_type() == torch.autograd.DeviceType.CPU or \
            event.is_user_annotation():
        return None
    activity = getattr(event, "activity_type", None)
    if activity is not None:
        return DEVICE_KINDS.get(activity())
    # a profiler that gives no activity kind (torch 2.11): the CUDA
    # runtime's own names of its copies and sets
    name = event.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    return "memset" if name.startswith("Memset") else "kernel"


def split(events):
    """(device operations, host operations, window start, window end) of
    a profile's raw events: each operation (start, end, name), a device
    one with its kind last."""
    dev, host = [], []
    lo = hi = None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == _WINDOW:
                lo, hi = e.start_ns(), e.end_ns()
            else:
                host.append((e.start_ns(), e.end_ns(), name))
        else:
            kind = device_kind(e)
            if kind is not None:
                dev.append((e.start_ns(), e.end_ns(), name, kind))
    return dev, host, lo, hi


class Recorder:
    """Profile the host and the device over a ``with`` block."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(_WINDOW)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def view(self, **kw) -> "View":
        parts = split(self.prof.profiler.kineto_results.events())
        self.prof = None
        return View(*parts, **kw)


def _union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class View:
    def __init__(self, dev, host, lo, hi, kind: str, steps: int,
                 window_s: float, step_work: Dict[str, float]):
        if lo is None:
            raise RuntimeError("the profiler recorded no window")
        self.kind, self.steps, self.step_work = kind, steps, step_work
        self.lo, self.hi = lo, hi
        self.window_s = window_s
        self.ops = [o for o in dev if o[1] > lo and o[0] < hi]
        self.host = sorted(host)
        self.busy = _union(self.ops, lo, hi)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.trace_s = (hi - lo) / 1e9

    # ---------------------------------------------------------- readers
    def idle_share(self) -> float:
        """The share of the traced window with no operation on the
        device."""
        return 1.0 - self.busy_s / self.trace_s

    def step_seconds(self) -> float:
        return self.window_s / self.steps

    def kernels(self) -> List[Tuple[int, int, str, str]]:
        """Kernel launches: device operations other than the runtime's
        copies and sets."""
        return [o for o in self.ops if o[3] == "kernel"]

    def class_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, n, _ in self.ops:
            out[class_of(n)] += (e - s) / 1e9
        return dict(out)

    # -------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, n, _ in self.ops:
            by[n] += (e - s) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        edges = [self.lo] + [x for iv in self.busy for x in iv] + [self.hi]
        for i in range(0, len(edges), 2):
            if edges[i + 1] > edges[i]:
                gaps.append((edges[i + 1] - edges[i], edges[i]))
        gaps.sort(reverse=True)
        named = [[self._host_at(t + g // 2), g / 1e9]
                 for g, t in gaps[:top]]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": named}

    def _host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for s, e, n in reversed(self.host[max(0, i - 20000):i]):
            if e >= t:
                return n[:200]
        return "none"

