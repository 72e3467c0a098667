#!/usr/bin/env python3
"""Profile one decode step (``make_serve_step``) of a registered arch at
its published widths on one card: where the step's device time goes, and
how busy the card is.

    python3 tools/profile_decode_step.py      # internlm2-1.8b, 16 x 32,768
    python3 tools/profile_decode_step.py --arch gemma3-1b --batch 8 \\
        --max-seq 1024 --cache bf16

The model is drawn from a seed, the decode state made by
``init_decode_state`` (int8 KV cache with ``--cache int8``; both caches, one
after the other, by default); two warm-up steps, then one under
``torch.profiler`` (CPU and CUDA activity), ending in a synchronisation.
Printed for each cache: the step's wall seconds, its kernels' summed
device time and the card's busy share, the device time by kernel, by class
of kernel and by torch operator (``tools/profile_train_step.py``'s
report), and the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=32_768)
    ap.add_argument("--cache", choices=("bf16", "int8", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from profile_train_step import print_profile
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import make_serve_step
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode_step needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = configs.get(args.arch)
    tree = Transformer(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev).tree()
    caches = ("bf16", "int8") if args.cache == "both" else (args.cache,)
    for cache in caches:
        c = cfg.replace(kv_cache_dtype="int8" if cache == "int8" else "")
        state = T.init_decode_state(c, args.batch, args.max_seq, device=dev)
        step = make_serve_step(c)
        token = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
        for _ in range(2):
            _, state = step(tree, state, token)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, state = step(tree, state, token)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_profile(prof, wall, f"decode {args.arch} {cfg.n_layers} layers,"
                      f" {cache} cache, batch {args.batch} x max_seq "
                      f"{args.max_seq}: step", smi)
        del state, prof
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
