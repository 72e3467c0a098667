#!/usr/bin/env python3
"""Time the split-KV decode attention kernel at the decode cells' shapes,
beside its byte bound and the plain path, in one process on one card.

    python3 tools/time_decode_attn.py                  # the port's source
    python3 tools/time_decode_attn.py OLD.cu NEW.cu --order ABBA

Each source is a ``decode_attn.cu`` with the C interface of
``build.SIGNATURES["decode_attn"]`` (its arguments packed by
``decode_attn.pack``); each is compiled with the port's nvcc
flags into ``build/time_decode_attn/`` (all at once, the wall seconds and
ptxas' registers, shared memory and spills printed) and loaded with
ctypes, so the versions see the same inputs.  Shapes: internlm2-decode-32k
(B 16, T 32,768, K 8, G 2, hd 128, pos 28,671) and olmoe-decode-4k (B 64,
T 4,096, K 16, G 1, hd 128, pos 3,583), bfloat16, keys at 3× scale; the
caches (1.9 and 1.0 GB a layer) exceed the 50 MB L2, so every launch reads
them from device memory.  Per shape: each source's output checked against
the port's plain path (``gqa_attend`` with the decode mask, the code it
replaces), then, in the given order of turns, the mean of CUDA-event
windows of ``--iters`` launches; the plain path's time; the bound (each
valid K and V slot read once at 3.35 TB/s); the profiler's split between
the kernel and its combine pass; and the host's microseconds a call, with
the card kept busy by a sleep kernel queued ahead, of what
``attention_decode``'s ``attend`` span holds on each path: ``admits`` and
the port's wrapper ``decode_attn``, against the decode mask and
``gqa_attend`` that it replaced.  Printed with the card's name and
power limit, and the JSON line also written to
``build/time_decode_attn.json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

OUT = ROOT / "build" / "time_decode_attn"
HBM = 3.35e12
# name: (B, T, K, G, hd, pos)
SHAPES = {"internlm2-decode-32k": (16, 32768, 8, 2, 128, 28671),
          "olmoe-decode-4k": (64, 4096, 16, 1, 128, 3583)}


def _compile(sources):
    """Build every source at once: [(library, ptxas log, seconds)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = OUT / f"{src.stem}-{i}-{key}.so"
        log = lib.with_suffix(".log")
        procs.append((subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=log.open("w"), stderr=subprocess.STDOUT), lib, log,
            time.perf_counter()))
    out = []
    for proc, lib, log, t0 in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log.read_text()}")
        out.append((lib, log.read_text(), time.perf_counter() - t0))
    return out


def _ptxas(log: str):
    """ptxas' lines of registers, shared memory and spills, one a kernel."""
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return keep


def _runner(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SIGNATURES["decode_attn"].items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    ready = set()

    def run(q, k, v, pos, scratch):
        b, _, h, hd = q.shape
        g = h // k.shape[2]
        if (hd, g) not in ready:
            build.check(lib.decode_attn_setup(0, hd, g), "decode_attn_setup")
            ready.add((hd, g))
        part_ml, part_acc, out = scratch
        params = DA.pack(q, k, v, pos, 0, part_ml.data_ptr(),
                         part_acc.data_ptr(), out.data_ptr())
        status = lib.decode_attn(ctypes.addressof(params),
                                 torch.cuda.current_stream().cuda_stream)
        build.check(status, "decode_attn")
        return out
    return run


def bytes_bound(b: int, t: int, kv: int, hd: int, pos: int,
                itemsize: int) -> int:
    """The bytes a call on a global layer needs: each K and V slot that
    the mask admits read once."""
    lo, hi, _ = DA.window_bounds(pos, t, 0)
    return 2 * b * (hi - lo) * kv * hd * itemsize


def _inputs(b, t, kv, g, hd, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale).to(torch.bfloat16)
    return (draw((b, 1, kv * g, hd)), draw((b, t, kv, hd), 3.0),
            draw((b, t, kv, hd)))


def _scratch(b, t, kv, g, hd):
    n_split, _ = DA.split_plan(b * kv, t)
    h = kv * g
    return (torch.empty((b * h, n_split, 2), dtype=torch.float64,
                        device="cuda"),
            torch.empty((b * h, n_split, hd), dtype=torch.float32,
                        device="cuda"),
            torch.empty((b, 1, h, hd), dtype=torch.bfloat16, device="cuda"))


def _time(fn, iters: int) -> float:
    """Mean milliseconds a call over ``iters`` calls, after two warm-ups."""
    fn()
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _profile_split(fn):
    """Device milliseconds a call of each kernel the call launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us:
            out[e.key[:60]] = dev_us / 1e3 / 5
    return out


def _host_us(fn, calls: int) -> float:
    """The host's mean microseconds a call over ``calls`` calls, after two
    warm-ups, with a sleep kernel queued ahead so that no call waits for
    the card (few calls: a launch waits once the device's queue fills)."""
    fn()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", type=Path,
                    default=[build.CSRC / "decode_attn.cu"])
    ap.add_argument("--order", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_decode_attn: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    built = _compile(args.sources)
    labels = "ABCDEFGH"[:len(built)]
    for lab, src, (lib, log, secs) in zip(labels, args.sources, built):
        print(f"[build] {lab} {src}: nvcc {secs:.2f} s")
        for ln in _ptxas(log):
            print(f"  {ln}")
    runners = [_runner(lib) for lib, _, _ in built]
    order = args.order or labels
    result = {"card": smi, "nvcc_s": [s for _, _, s in built], "shapes": {}}
    for name, (b, t, kv, g, hd, pos) in SHAPES.items():
        q, k, v = _inputs(b, t, kv, g, hd)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        mask = L.gqa_scores_mask(p.reshape(1), torch.arange(
            t, dtype=torch.int32, device="cuda"), False, 0)
        plain = L.gqa_attend(q, k, v, mask)
        scratch = _scratch(b, t, kv, g, hd)
        diffs = []
        for run in runners:
            got = run(q, k, v, p, scratch).clone()
            diffs.append(float((got.float() - plain.float()).abs().max()))
        turns = {lab: [] for lab in labels}
        for lab in order:
            run = runners[labels.index(lab)]
            turns[lab].append(_time(lambda: run(q, k, v, p, scratch),
                                    args.iters))
        plain_ms = _time(lambda: L.gqa_attend(q, k, v, mask), 3)
        nbytes = bytes_bound(b, t, kv, hd, pos, 2)
        bound_ms = nbytes / HBM * 1e3
        split = _profile_split(lambda: runners[0](q, k, v, p, scratch))

        def wrapper():
            assert DA.admits(q, k, v)
            return DA.decode_attn(q, k, v, p, False, 0)

        def replaced():
            m = L.gqa_scores_mask(p.reshape(1), torch.arange(
                t, dtype=torch.int32, device="cuda"), False, 0)
            return L.gqa_attend(q, k, v, m)
        host_us = {"decode_attn": _host_us(wrapper, 40),
                   "gqa_attend": _host_us(replaced, 10)}
        row = {"shape": [b, t, kv, g, hd, pos], "bytes": nbytes,
               "bound_ms": bound_ms, "kernel_ms": turns,
               "roofline_pct": {lab: 100 * bound_ms / min(ms)
                                for lab, ms in turns.items()},
               "plain_ms": plain_ms, "max_diff_vs_plain": diffs,
               "profile_ms": split, "host_us": host_us}
        result["shapes"][name] = row
        print(f"[{name}] B {b} T {t} K {k.shape[2]} G {g} hd {hd} pos {pos}: "
              f"bound {bound_ms:.4f} ms ({nbytes} B); plain {plain_ms:.3f} ms")
        for lab in labels:
            ms = turns[lab]
            print(f"  {lab}: " + " / ".join(f"{x:.4f}" for x in ms)
                  + f" ms ({100 * bound_ms / min(ms):.1f} % of the bound); "
                  f"max |out - plain| {diffs[labels.index(lab)]:.3g}")
        for kname, ms in sorted(split.items(), key=lambda kv_: -kv_[1]):
            print(f"  profile {kname}: {ms:.4f} ms a call")
        print(f"  host: admits + decode_attn {host_us['decode_attn']:.1f} µs "
              f"a call; mask + gqa_attend {host_us['gqa_attend']:.1f} µs")
        del q, k, v, plain, scratch
        torch.cuda.empty_cache()
    out = ROOT / "build" / "time_decode_attn.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
