#!/usr/bin/env python3
"""Time builds of the port's bitplane codec kernels against each other, in
turns, in one process on one card.

    python3 tools/time_bitplane.py OLD.cu NEW.cu            # turns A B B A
    python3 tools/time_bitplane.py OLD.cu NEW.cu --order ABBAAB

Each source must have the plain C interface of
``src/repro_torch/kernels/csrc/bitplane.cu`` (``build.SIGNATURES
["bitplane"]``).  Each is compiled with the port's nvcc flags into
``build/time_bitplane/`` (all at once) and loaded with ctypes, so two
versions of the kernels live in one process and see the same inputs.
Every source's outputs are first checked equal to the first source's.
Then, in the given order of turns, each source is timed with CUDA events
on pre-allocated outputs: encode at N = 2^23 and nbits = 48, decode at
N = 2^23 with P = 1, 4, 16 and 48 descending-run shifts, and decode at
P = 48 with general shifts.  Printed per source: ptxas' registers and
spills, static SASS instruction counts, and each turn's milliseconds
beside the bytes bound; the card's nvidia-smi line; and one JSON line,
also written to ``build/time_bitplane.json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "time_bitplane"
N = 1 << 23
NBITS = 48


def _compile(sources):
    """Build every source at once; returns [(library, ptxas log)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = OUT / f"{src.stem}-{key}.so"
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


def _load(lib: Path):
    """The built library with the C signatures of the entry points it has
    (an older source may lack the batched decode, which is not timed
    here)."""
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in build.SIGNATURES["bitplane"].items():
        if hasattr(dll, fn):
            getattr(dll, fn).argtypes = list(argtypes)
            getattr(dll, fn).restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--order", default="ABBA",
                    help="turns, one letter per source (A = first)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    _, _, smi = smoke.phase_device()
    built = _compile(args.sources)
    libs = [_load(lib) for lib, _ in built]
    report = {"device": smi, "sources": {}}
    for src, (lib, log) in zip(args.sources, built):
        report["sources"][str(src)] = {
            "ptxas": [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line],
            "sass": {k: smoke.sass_counts(lib, k)
                     for k in ("bitplane_encode_kernel",
                               "bitplane_decode_kernel")},
            "ms": {}}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nwords = N // 32
    c = torch.randn(N, dtype=torch.float64, device=dev, generator=gen)
    c *= torch.exp(12 * torch.rand(N, dtype=torch.float64, device=dev,
                                   generator=gen) - 6)
    scale = 2.0 ** (NBITS - 1 - int(np.ceil(np.log2(float(c.abs().max())))))
    words = torch.randint(-2 ** 31, 2 ** 31, (64, nwords), dtype=torch.int32,
                          device=dev, generator=gen)
    state = torch.randint(0, 2 ** 48, (N,), dtype=torch.int64, device=dev,
                          generator=gen)
    sb = torch.randint(0, 256, (N // 8,), dtype=torch.uint8, device=dev,
                       generator=gen)
    rng = np.random.default_rng(0)
    shifts = {p: torch.arange(NBITS - 1, NBITS - 1 - p, -1, dtype=torch.int64,
                              device=dev) for p in smoke.DEC_TIMED_PLANES}
    holes = torch.from_numpy(smoke.plane_shifts("holes", NBITS, rng)).to(dev)
    planes = torch.empty((NBITS, nwords), dtype=torch.int32, device=dev)
    mag = torch.empty(N, dtype=torch.int64, device=dev)
    vals = torch.empty(N, dtype=torch.float64, device=dev)

    def encode(lib):
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: build.check(lib.bitplane_encode(
            c.data_ptr(), scale, N, nwords, NBITS, planes.data_ptr(),
            stream), "bitplane_encode")

    def decode(lib, p, sh):
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: build.check(lib.bitplane_decode(
            words.data_ptr(), sh.data_ptr(), p, nwords, state.data_ptr(),
            mag.data_ptr(), sb.data_ptr(), 2.0 ** -40, vals.data_ptr(),
            stream), "bitplane_decode")

    cases = {"encode_48": (lambda lib: encode(lib),
                           smoke.encode_bytes(NBITS, N))}
    for p in smoke.DEC_TIMED_PLANES:
        cases[f"decode_{p}"] = ((lambda lib, p=p: decode(lib, p, shifts[p])),
                                smoke.decode_bytes(p, nwords))
    cases["decode_48_general"] = ((lambda lib: decode(lib, NBITS, holes)),
                                  smoke.decode_bytes(NBITS, nwords))

    # every source computes the same outputs as the first
    want = {}
    for i, lib in enumerate(libs):
        for name, (make, _) in cases.items():
            make(lib)()
            torch.cuda.synchronize()
            got = (planes.clone(),) if name.startswith("encode") else \
                (mag.clone(), vals.view(torch.int64).clone())
            if i == 0:
                want[name] = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want[name])):
                raise AssertionError(f"{args.sources[i]} differs from "
                                     f"{args.sources[0]} in {name}")
    print(f"[time] outputs of {len(libs)} sources equal in "
          f"{len(cases)} cases")

    for turn, letter in enumerate(args.order):
        i = ord(letter) - ord("A")
        src = str(args.sources[i])
        for name, (make, nbytes) in cases.items():
            ms = smoke._cuda_ms(make(libs[i]), reps=21, per=10)
            report["sources"][src]["ms"].setdefault(name, []).append(ms)
            print(f"[time] turn {turn} {letter} {src} {name}: {ms:.4f} ms, "
                  f"bound {nbytes / smoke.HBM_BYTES_PER_S * 1e3:.4f} ms")
    report["bound_ms"] = {name: nbytes / smoke.HBM_BYTES_PER_S * 1e3
                          for name, (_, nbytes) in cases.items()}
    for src, r in report["sources"].items():
        print(f"[time] {src}: ptxas {r['ptxas']}")
        for k, v in r["sass"].items():
            print(f"[time] {src}: {k} SASS {v}")
    line = json.dumps(report)
    dump = ROOT / "build" / "time_bitplane.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line)
    print(line)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
