#!/usr/bin/env python3
"""Time the progressive checkpoint's codec on one embed-sized leaf, on one
card: the host entropy stage in process against a pool of processes.

    python3 tools/time_checkpoint.py               # internlm2's embed leaf
    python3 tools/time_checkpoint.py --n 16777216

The leaf is ``--n`` bfloat16 standard normal draws (seeded, on the card;
189,530,112 = 92,544 x 2,048, internlm2-1.8b's embedding table, by
default), widened to float64 as ``train/checkpoint.py`` does.  For the
pool the trainer makes for a tree of ``--n`` elements
(``checkpoint.entropy_pool``: ``--n`` must be at least its
``POOL_MIN_ELEMENTS``) and then in process, it times
``encode_level`` (B1 on the card, the planes to the host, the entropy
stage) and ``decode_prefix`` at all 48 planes and at the plane count a
relative tau of 1e-4 needs (the planes inflate on the host, B2 decodes on
the card), each ending in a synchronisation, the pool's workers started
before; the blobs must be equal and
the 48-plane decode exact.  Then the card's nvidia-smi line and one JSON
line, also written to ``build/time_checkpoint.json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=92_544 * 2_048)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.bitplane import encoder as E
    from repro_torch.train import checkpoint as C
    if not torch.cuda.is_available():
        raise RuntimeError("time_checkpoint needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.n, generator=gen, dtype=torch.bfloat16,
                    device=dev).to(torch.float64)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, blobs = {}, {}
    pool = C.entropy_pool(args.n)
    if pool is None:
        raise SystemExit(f"--n {args.n}: the trainer runs the entropy stage "
                         f"of fewer than {C.POOL_MIN_ELEMENTS} elements (or "
                         f"on one core) in process; there is no pool to time")
    workers = C.default_workers()
    try:
        # start the workers (spawned, they import the codecs) before timing
        warm = E.encode_level(x[: 1 << 20], executor=pool)
        E.decode_prefix(warm, 48, dev, pool)
        for label, ex in ((f"pool of {workers}", pool),
                          ("in process", None)):
            lbp, enc_s = timed(lambda: E.encode_level(x, executor=ex))
            k = E.planes_needed(lbp, 1e-4 * 2.0 ** lbp.exponent)
            full, dec_s = timed(lambda: E.decode_prefix(lbp, 48, dev, ex))
            _, part_s = timed(lambda: E.decode_prefix(lbp, k, dev, ex))
            if not torch.equal(full, x):
                raise AssertionError(f"{label}: the 48-plane decode is not "
                                     f"the leaf")
            blobs[label] = (lbp.planes, lbp.signs)
            out[label] = {"encode_s": enc_s, "decode48_s": dec_s,
                          f"decode{k}_s": part_s, "bytes": lbp.total_nbytes,
                          "planes_tau_1e-4": k}
            print(f"[checkpoint] n={args.n} {label}: encode {enc_s:.2f}s, "
                  f"decode 48 planes {dec_s:.2f}s, {k} planes (tau 1e-4) "
                  f"{part_s:.2f}s; {lbp.total_nbytes} B")
            del full
    finally:
        pool.shutdown()
    a, b = blobs.values()
    if a != b:
        raise AssertionError("the pool's blobs differ from the in-process "
                             "ones")
    print(smi)
    result = {"n": args.n, "workers": workers, "device": smi, **out}
    dump = ROOT / "build" / "time_checkpoint.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
