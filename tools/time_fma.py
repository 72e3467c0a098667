#!/usr/bin/env python3
"""Time the port's ``fma_rn`` kernel against ``torch.addcmul``, in turns,
in one process on one card.

    python3 tools/time_fma.py                  # turns A B B A
    python3 tools/time_fma.py --order ABBAABBA

A is ``repro_torch.kernels.fma.fma`` (the CUDA kernel ``csrc/fma.cu``), B is
one PyTorch call computing the same function, ``torch.addcmul(c, a, b)``
(``c + 1·a·b``, which the card rounds once).  Two cases at N = 2^24
float64: three full tensors (32 B per element moved), and a float factor
(``fma(s, b, c)`` against ``torch.addcmul(c, b, s)`` with ``s`` a 0-d
tensor on the card; 24 B per element).  Both calls are first checked
bit-equal on random and cancelling triples.  Then, in the given order of
turns, each is timed with CUDA events (median of 21 windows of 20 calls).
Printed: each turn's milliseconds beside the bytes bound (bytes over the
card's memory rate), the card's nvidia-smi line, and one JSON line, also
written to ``build/time_fma.json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)

N = 1 << 24
SCALE = 1.0 / 12.0       # the float factor of ob's load vector


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="ABBA",
                    help="turns, A = fma_rn, B = torch.addcmul")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels.fma import fma
    _, _, smi = smoke.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b, c = _triples(N, gen)
    s = torch.tensor(SCALE, dtype=torch.float64, device="cuda")
    cases = {
        "tensors": ((lambda: fma(a, b, c)),
                    (lambda: torch.addcmul(c, a, b)), 32 * N),
        "float_factor": ((lambda: fma(SCALE, b, c)),
                         (lambda: torch.addcmul(c, b, s)), 24 * N),
    }
    for name, (fa, fb, _) in cases.items():
        x, y = fa(), fb()
        same = (smoke._bits(x) == smoke._bits(y)) | \
            (torch.isnan(x) & torch.isnan(y))
        differ = int((~same).sum())
        if differ:
            raise AssertionError(f"{name}: torch.addcmul differs from fma_rn "
                                 f"in {differ} of {N} elements")
    print(f"[time] fma_rn and torch.addcmul bit-equal on {N} random and "
          f"cancelling triples, with three tensors and with a float factor")
    report = {"device": smi, "n": N, "order": args.order, "cases": {}}
    for name, (_, _, nbytes) in cases.items():
        report["cases"][name] = {
            "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
            "ms": {"fma_rn": [], "torch.addcmul": []}}
    for turn, letter in enumerate(args.order):
        who = "fma_rn" if letter == "A" else "torch.addcmul"
        for name, (fa, fb, _) in cases.items():
            ms = smoke._cuda_ms(fa if letter == "A" else fb, reps=21, per=20)
            r = report["cases"][name]
            r["ms"][who].append(ms)
            print(f"[time] turn {turn} {letter} {who} {name}: {ms:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_ms'] / ms:.0%})")
    for name, r in report["cases"].items():
        k, lib = r["ms"]["fma_rn"], r["ms"]["torch.addcmul"]
        r["fma_rn_slower_in_every_turn"] = min(k) > max(lib) \
            if k and lib else None
        print(f"[time] {name}: fma_rn {k}, torch.addcmul {lib}; fma_rn "
              f"slower in every turn: {r['fma_rn_slower_in_every_turn']}")
    text = json.dumps(report)
    dump = ROOT / "build" / "time_fma.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(text)
    print(text)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
