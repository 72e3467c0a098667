#!/usr/bin/env python3
"""Time builds of the port's ``fma_rn`` kernel against each other and
against ``torch.addcmul``, in turns, in one process on one card.

    python3 tools/time_fma.py                  # the port's fma.cu: A B B A
    git show <commit>:src/repro_torch/kernels/csrc/fma.cu > build/prev/fma.cu
    python3 tools/time_fma.py build/prev/fma.cu \\
        src/repro_torch/kernels/csrc/fma.cu    # turns A B C C B A
    python3 tools/time_fma.py OLD.cu NEW.cu --order ABCABC

Each source is an ``fma.cu`` with the C interface of
``build.SIGNATURES["fma"]``; with none given, the port's own.  Every source
is compiled with the port's nvcc flags into ``build/time_fma/`` (all at
once) and loaded with ctypes, so the versions live in one process and see
the same inputs.  Letters A, B, ... name the sources in order; the letter
after the last source is ``torch.addcmul``, one PyTorch call computing the
same function (``c + 1·a·b``, which the card rounds once).  Cases:

- ``tensors``: three full tensors, N = 2^24 (32 B per element moved);
- ``float_factor``: ``fma(1/12, b, c)`` against ``torch.addcmul(c, b, s)``
  with ``s`` a 0-d tensor on the card, N = 2^24 (24 B per element);
- ``ob_layout``: ob's load vector on a 1-D field, ``fma(1/12, even[:-1],
  b[1:])``: ``b`` a stride-2 view, ``c`` 8 B off 16-B alignment, N = 2^23
  (24 B per element).  Also timed: the copy of the stride-2 view that the
  wrapper made before each such launch while it copied every strided
  operand.

Every source's output is first checked bit-equal to the plain version
``fma_ref`` in every case (random and cancelling triples); so is
``torch.addcmul``'s, whose differences are counted, not raised.  Then, in
the given order of turns, each is timed with CUDA events (median of 21
windows of 20 calls).  Then the Python wrapper ``fma()`` against
``torch.addcmul`` at N = 2^10 and 2^16, where the launch and not the bytes
sets the time (turns A B B A, windows of 200 calls, beside the new
kernel's device time from a CUDA graph), and the wrapper's host cost
per launch step by step, with the steps it took before it was trimmed
(``torch.broadcast_shapes``, the device context and ``build.load`` on
every call) and ``torch.addcmul``'s whole call.  Printed:
ptxas' registers and spills per source, each turn's milliseconds beside
the bytes bound, the card's nvidia-smi line, and one JSON line, also
written to ``build/time_fma.json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "time_fma"
N = 1 << 24
N_OB = 1 << 23
SMALL = (1 << 10, 1 << 16)
SCALE = 1.0 / 12.0       # the float factor of ob's load vector


def _compile(sources):
    """Build every source at once; returns [(library, ptxas log)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = OUT / f"{src.stem}-{i}-{key}.so"
        log = lib.with_suffix(".log")
        procs.append((subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=log.open("w"), stderr=subprocess.STDOUT), lib, log))
    out = []
    for proc, lib, log in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log.read_text()}")
        out.append((lib, log.read_text()))
    return out


def _ptxas(log: str) -> dict:
    """Registers and spill bytes over the kernels of one ptxas report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"kernels": len(regs), "registers": [min(regs), max(regs)]
            if regs else None, "spill_bytes": sum(spills)}


def _kernel(path: Path):
    """run(a, b, c, out) through one library's C entry point; an operand is
    a tensor (any 1-D stride, 0 for one value) or a float (by value)."""
    import torch
    fn = ctypes.CDLL(str(path)).fma_rn
    fn.argtypes = list(build.SIGNATURES["fma"]["fma_rn"])
    fn.restype = ctypes.c_int

    def operand(x):
        if isinstance(x, torch.Tensor):
            return x.data_ptr(), 0.0, x.stride(0) if x.dim() else 0
        return None, x, 0

    def run(a, b, c, out):
        build.check(fn(*operand(a), *operand(b), *operand(c), out.numel(),
                       out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                    "fma_rn")
    return run


def _triples(n, gen):
    """Random float64 triples over a wide exponent range, half of them with
    c cancelling a·b to about an ulp."""
    import torch

    def rand():
        x = torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
        e = torch.randint(-60, 60, (n,), device="cuda", generator=gen)
        return x * torch.exp2(e.double())
    a, b = rand(), rand()
    near = -(a * b) * (1 + 2.0 ** -52)
    c = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.5,
                    near, rand())
    return a, b, c


def _differ(x, y) -> int:
    import torch
    return int((~((smoke._bits(x) == smoke._bits(y))
                  | (torch.isnan(x) & torch.isnan(y)))).sum())


def _host_us(fn, calls=5000) -> float:
    """Host microseconds per call, median of 5 runs."""
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return sorted(runs)[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", type=Path,
                    default=[build.CSRC / "fma.cu"])
    ap.add_argument("--order", default=None,
                    help="turns, one letter per source, then one for "
                         "torch.addcmul (default: each once, then reversed)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import fma as fma_mod
    from repro_torch.kernels.ref import fma_ref
    names = [str(s) for s in args.sources] + ["torch.addcmul"]
    letters = "".join(chr(ord("A") + i) for i in range(len(names)))
    order = args.order or letters + letters[::-1]
    _, _, smi = smoke.phase_device()
    built = _compile(args.sources)
    kernels = [_kernel(lib) for lib, _ in built]
    report = {"device": smi, "order": order, "sources": {}, "cases": {}}
    for src, (_, log) in zip(names, built):
        report["sources"][src] = _ptxas(log)
        print(f"[time] {src}: ptxas {report['sources'][src]}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b, c = _triples(N, gen)
    s = torch.tensor(SCALE, dtype=torch.float64, device="cuda")
    field = torch.randn(2 * N_OB + 1, dtype=torch.float64, device="cuda",
                        generator=gen)
    acc = torch.randn(N_OB + 1, dtype=torch.float64, device="cuda",
                      generator=gen)
    even, tail = field[0::2][:-1], acc[1:]   # stride 2; 8 B off alignment
    assert even.stride(0) == 2 and tail.data_ptr() % 16 == 8
    # name: (a, b, c, addcmul's (input, tensor1, tensor2), n, bytes)
    cases = {"tensors": (a, b, c, (c, a, b), N, 32 * N),
             "float_factor": (SCALE, b, c, (c, b, s), N, 24 * N),
             "ob_layout": (SCALE, even, tail, (tail, even, s), N_OB,
                           24 * N_OB)}
    outs = {name: torch.empty(case[4], dtype=torch.float64, device="cuda")
            for name, case in cases.items()}

    def call(i, name):
        fa, fb, fc, lib_args, _, _ = cases[name]
        if i == len(kernels):
            return lambda: torch.addcmul(*lib_args)
        return lambda: kernels[i](fa, fb, fc, outs[name])

    for name, (fa, fb, fc, lib_args, n, nbytes) in cases.items():
        want = fma_ref(*(t if isinstance(t, torch.Tensor) else
                         torch.tensor(t, dtype=torch.float64, device="cuda")
                         for t in (fa, fb, fc)))
        for i, src in enumerate(names[:-1]):
            call(i, name)()
            if _differ(outs[name], want):
                raise AssertionError(f"{src} differs from fma_ref in {name} "
                                     f"in {_differ(outs[name], want)} of {n}")
        r = report["cases"][name] = {
            "n": n, "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
            "addcmul_differs": _differ(torch.addcmul(*lib_args), want),
            "ms": {src: [] for src in names}}
        print(f"[time] {name}: {len(names) - 1} source(s) bit-equal to "
              f"fma_ref on {n} random and cancelling triples; torch.addcmul "
              f"differs in {r['addcmul_differs']}")
    report["cases"]["ob_layout"]["copy_ms"] = smoke._cuda_ms(
        even.contiguous, 21, 20)

    for turn, letter in enumerate(order):
        i = ord(letter) - ord("A")
        for name, r in report["cases"].items():
            ms = smoke._cuda_ms(call(i, name), reps=21, per=20)
            r["ms"][names[i]].append(ms)
            print(f"[time] turn {turn} {letter} {names[i]} {name}: "
                  f"{ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_ms'] / ms:.0%})")
    print(f"[time] ob_layout: the copy of the stride-2 view, once made first "
          f"{report['cases']['ob_layout']['copy_ms']:.4f} ms")
    for name, r in report["cases"].items():
        lib = r["ms"]["torch.addcmul"]
        # each source's i-th turn against torch.addcmul's i-th turn
        r["slower_than_addcmul_in_a_turn"] = {
            src: any(k > m for k, m in zip(ms, lib))
            for src, ms in r["ms"].items() if src != "torch.addcmul"}
        print(f"[time] {name}: {r['ms']}; slower than torch.addcmul in "
              f"some turn: {r['slower_than_addcmul_in_a_turn']}")

    # the wrapper at launch-bound sizes, and the new kernel alone
    new = kernels[-1]
    report["small"] = {}
    for n in SMALL:
        x, y, z = (t[:n].clone() for t in (a, b, c))
        o = torch.empty_like(x)
        forms = {"tensors": (lambda: fma_mod.fma(x, y, z),
                             lambda: torch.addcmul(z, x, y),
                             lambda: new(x, y, z, o)),
                 "float_factor": (lambda: fma_mod.fma(SCALE, y, z),
                                  lambda: torch.addcmul(z, y, s),
                                  lambda: new(SCALE, y, z, o))}
        for form, (wrap, lib, alone) in forms.items():
            r = report["small"][f"{form}_{n}"] = {
                "fma": [], "torch.addcmul": [],
                "kernel_graph_ms": smoke._graph_ms(alone, 11, 200)}
            for who in "ABBA":
                key = "fma" if who == "A" else "torch.addcmul"
                r[key].append(smoke._cuda_ms(wrap if who == "A" else lib,
                                             reps=11, per=200))
            print(f"[time] N={n} {form}: fma() {r['fma']} ms, torch.addcmul "
                  f"{r['torch.addcmul']} ms per call (windows of 200); the "
                  f"kernel alone {r['kernel_graph_ms']:.5f} ms (CUDA graph)")

    # the wrapper's host work per launch, step by step, at N = 2^10
    x, y, z = (t[:SMALL[0]].clone() for t in (a, b, c))
    o = torch.empty_like(x)
    shapes = [x.shape, y.shape, z.shape]
    launch = fma_mod._kernel()
    ops = [fma_mod._launch_operand(t, x.shape)[0] for t in (x, y, z)]
    stream = torch.cuda.current_stream().cuda_stream

    def context_and_load():     # what each launch did before the trim
        with torch.cuda.device(x.device):
            build.load("fma")
            return torch.cuda.current_stream(x.device).cuda_stream
    steps = {
        "torch.broadcast_shapes (before)":
            lambda: torch.broadcast_shapes(*shapes),
        "device context, build.load, stream (before)": context_and_load,
        "equal-shape test": lambda: all(sh == shapes[0] for sh in shapes),
        "current_device, cached entry point, stream": lambda: (
            torch.cuda.current_device(), fma_mod._kernel(),
            torch.cuda.current_stream().cuda_stream),
        "operand checks": lambda: fma_mod._device(x, y, z),
        "torch.empty": lambda: torch.empty(x.shape, dtype=torch.float64,
                                           device=x.device),
        "operands": lambda: [fma_mod._launch_operand(t, x.shape)
                             for t in (x, y, z)],
        "C call and its launch": lambda: launch(
            *ops[0], *ops[1], *ops[2], x.numel(), o.data_ptr(), stream),
        "fma() in all": lambda: fma_mod.fma(x, y, z),
        "torch.addcmul in all": lambda: torch.addcmul(z, x, y),
    }
    report["host_us"] = {}
    for step, fn in steps.items():
        report["host_us"][step] = _host_us(fn)
        torch.cuda.synchronize()
        print(f"[time] host µs per call, {step}: "
              f"{report['host_us'][step]:.2f}")

    text = json.dumps(report)
    dump = ROOT / "build" / "time_fma.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(text)
    print(text)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
