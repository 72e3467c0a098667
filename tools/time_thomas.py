#!/usr/bin/env python3
"""Time builds of the port's Thomas solve against each other, in turns, in
one process on one card.

    git show <commit>:src/repro_torch/kernels/csrc/thomas.cu > build/prev/thomas.cu
    python3 tools/time_thomas.py build/prev/thomas.cu \\
        src/repro_torch/kernels/csrc/thomas.cu              # turns A B B A
    python3 tools/time_thomas.py OLD.cu NEW.cu --order ABBAAB

Each source is a ``thomas.cu`` with one of the two C interfaces the port
has had: ``thomas_solve(b, table, h, pre, n, post, out, stream)`` with the
factor table of ``kernels/thomas.py`` (``build.SIGNATURES["thomas"]``), or
``thomas_factors(n, cp, denom, stream)`` beside ``thomas_solve(b, cp,
denom, pre, n, post, out, stream)``, whose n-long factors its own kernel
computes once per length (untimed).  Each source, and the chain probe
``tools/chain_probe.cu``, is compiled with the port's nvcc flags into
``build/time_thomas/`` (all at once) and loaded with ctypes, so the
versions live in one process and see the same inputs: the 2^23+1-node
line of the main path and a 257^3 field along axes 0, 1 and 2.  Every
source's outputs are first checked bit-equal to the first source's.  Then,
in the given order of turns, each source is timed with CUDA events.
Printed: ptxas' registers and spills per source, each turn's milliseconds
beside the bound (16 B per node over the card's memory rate; for the line
also its dependent chain, by the kernel's quotient and by the division,
from the probe), the card's nvidia-smi line, and one JSON line, also
written to ``build/time_thomas.json`` (git-ignored).
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

OUT = ROOT / "build" / "time_thomas"
LINE = (1 << 23) + 1
CUBE = 257


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


def _solver(path: Path):
    """run(b, pre, n, post, out) for a library of either interface."""
    import torch
    from repro_torch.kernels.thomas import thomas_table
    lib = ctypes.CDLL(str(path))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    if hasattr(lib, "thomas_factors"):
        lib.thomas_factors.argtypes = [ll, p, p, p]
        lib.thomas_factors.restype = ctypes.c_int
        lib.thomas_solve.argtypes = [p, p, p, ll, ll, ll, p, p]
        lib.thomas_solve.restype = ctypes.c_int
        factors = {}

        def run(b, pre, n, post, out):
            stream = torch.cuda.current_stream().cuda_stream
            if n not in factors:
                cp = torch.empty(n, dtype=torch.float64, device="cuda")
                denom = torch.empty_like(cp)
                build.check(lib.thomas_factors(n, cp.data_ptr(),
                                               denom.data_ptr(), stream),
                            "thomas_factors")
                factors[n] = (cp, denom)
            cp, denom = factors[n]
            build.check(lib.thomas_solve(
                b.data_ptr(), cp.data_ptr(), denom.data_ptr(), pre, n, post,
                out.data_ptr(), stream), "thomas_solve")
        return run
    lib.thomas_solve.argtypes = list(build.SIGNATURES["thomas"]["thomas_solve"])
    lib.thomas_solve.restype = ctypes.c_int

    def run(b, pre, n, post, out):
        stream = torch.cuda.current_stream().cuda_stream
        table, h = thomas_table(n, "cuda")
        build.check(lib.thomas_solve(
            b.data_ptr(), table.data_ptr(), h, pre, n, post, out.data_ptr(),
            stream), "thomas_solve")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--order", default="ABBA",
                    help="turns, one letter per source (A = first)")
    args = ap.parse_args(argv)
    import torch
    _, _, smi = smoke.phase_device()
    built = _compile([*args.sources, smoke.CHAIN_PROBE])
    probe = smoke.load_chain_probe(built[-1][0])
    built = built[:-1]
    solvers = [_solver(lib) for lib, _ in built]
    report = {"device": smi, "sources": {}}
    for src, (_, log) in zip(args.sources, built):
        report["sources"][str(src)] = {
            "ptxas": [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line
                      or "Compiling" in line],
            "ms": {}}

    gen = torch.Generator(device="cuda").manual_seed(0)
    line = torch.randn(LINE, dtype=torch.float64, device="cuda", generator=gen)
    cube = torch.randn((CUBE,) * 3, dtype=torch.float64, device="cuda",
                       generator=gen)
    cases = {"line_2^23+1": (line, 1, LINE, 1)}
    for ax in range(3):
        cases[f"cube{CUBE}_axis{ax}"] = (cube, CUBE ** ax, CUBE,
                                         CUBE ** (2 - ax))
    outs = {name: torch.empty_like(c[0]) for name, c in cases.items()}

    want = {}
    for i, run in enumerate(solvers):
        for name, (b, pre, n, post) in cases.items():
            run(b, pre, n, post, outs[name])
            torch.cuda.synchronize()
            bits = outs[name].view(torch.int64).clone()
            if i == 0:
                want[name] = bits
            elif not torch.equal(bits, want[name]):
                raise AssertionError(f"{args.sources[i]} differs from "
                                     f"{args.sources[0]} in {name}")
    print(f"[time] outputs of {len(solvers)} sources bit-equal in "
          f"{len(cases)} cases")

    t_fd, t_fq, t_f = smoke.chain_latency_ns(probe)
    bounds = {}
    for name, (b, pre, n, post) in cases.items():
        bytes_ms = 16 * b.numel() / smoke.HBM_BYTES_PER_S * 1e3
        bounds[name] = {"bytes_ms": bytes_ms,
                        "chain_ms": n * (t_fq + t_f) / 1e6,
                        "division_chain_ms": n * (t_fd + t_f) / 1e6}
        bounds[name]["bound_ms"] = max(bytes_ms, bounds[name]["chain_ms"])
    report["chain_ns"] = {"fma_div": t_fd, "fma_quot": t_fq, "fma": t_f}
    report["bounds"] = bounds
    print(f"[time] chain probe: fma+div {t_fd:.2f} ns, fma+quotient "
          f"{t_fq:.2f} ns, fma {t_f:.2f} ns per step ({smi})")

    for turn, letter in enumerate(args.order):
        i = ord(letter) - ord("A")
        src = str(args.sources[i])
        for name, (b, pre, n, post) in cases.items():
            reps, per = (3, 1) if name.startswith("line") else (11, 4)
            ms = smoke._cuda_ms(
                lambda: solvers[i](b, pre, n, post, outs[name]), reps, per)
            report["sources"][src]["ms"].setdefault(name, []).append(ms)
            bd = bounds[name]
            print(f"[time] turn {turn} {letter} {src} {name}: {ms:.4f} ms, "
                  f"bound {bd['bound_ms']:.4f} ms ({bd['bound_ms'] / ms:.0%};"
                  f" bytes {bd['bytes_ms']:.4f}, chain {bd['chain_ms']:.4f},"
                  f" by the division {bd['division_chain_ms']:.4f})")
    for src, r in report["sources"].items():
        print(f"[time] {src}: ptxas {r['ptxas']}")
    text = json.dumps(report)
    dump = ROOT / "build" / "time_thomas.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(text)
    print(text)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
