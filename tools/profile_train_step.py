#!/usr/bin/env python3
"""Profile one training step of a registered arch (internlm2-1.8b unless
``--arch``) at its published widths on one card: where the step's device
time goes, and how busy the card is.

    python3 tools/profile_train_step.py             # batch 4 x seq 1024
    python3 tools/profile_train_step.py --arch mamba2-780m
    python3 tools/profile_train_step.py --arch olmoe-1b-7b --layers 4

The step is ``launch/train.py``'s (eager autograd with remat, 8-plane
gradient compression, clip, the config's optimizer, parameters copied
back), on a model drawn from a seed; two warm-up steps, then one under
``torch.profiler`` (CPU and CUDA activity), ending in a synchronisation.
Printed: the step's wall seconds, the summed device time of its kernels
and their share of the wall time (the card's busy share; one stream), the
device time by kernel (matrix-product kernels summed as one row), by
class of kernel (matrix products, index/scatter/gather, scans, softmax and
reductions, the rest elementwise), the torch operators with the most
device time of their own, and the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

_MATMUL = ("gemm", "cutlass", "sm90_", "xmma", "nvjet")
# kernel classes by name, first match wins
_CLASSES = (("matrix products", _MATMUL),
            ("index, scatter, gather", ("index", "scatter", "gather")),
            ("scans (cumsum, cummax)", ("scan", "cumsum", "cummax")),
            ("sort", ("sort", "radix")),
            ("softmax and reductions", ("softmax", "reduce", "norm")))


def _class_of(name: str) -> str:
    low = name.lower()
    for label, keys in _CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise and copies"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0 = the config's)")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data.batches import make_train_batch
    from repro_torch.launch.train import _assign
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.grad_compress import compress_decompress, \
        zeros_like_feedback
    from repro_torch.train.optimizer import clip_by_global_norm, \
        make_optimizer
    from repro_torch.train.train_step import value_and_grad
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_step needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = configs.get(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    dev = torch.device("cuda")
    model = Transformer(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    state = {"opt": opt_init(model.tree()),
             "fb": zeros_like_feedback(model.tree())}

    def step(s: int) -> float:
        batch = make_train_batch(cfg, args.batch, args.seq, seed=s,
                                 device=dev)
        loss, _, grads = value_and_grad(cfg, model.tree(), batch)
        grads, state["fb"] = compress_decompress(grads, state["fb"], 8)
        grads, _ = clip_by_global_norm(grads, 1.0)
        new, state["opt"] = opt_update(model.tree(), grads, state["opt"],
                                       lr=3e-3)
        _assign(model, new)
        return float(loss)

    for s in range(2):
        step(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, wall, f"{args.arch} {cfg.n_layers} layers, batch "
                  f"{args.batch} x seq {args.seq}: loss {loss:.4f}; step",
                  smi)
    return 0


def print_profile(prof, wall: float, head: str, smi: str) -> None:
    """The profiled window's wall seconds beside its kernels' summed device
    time (the busy share; one stream), then the device time by kernel, by
    class of kernel and by torch operator, and the nvidia-smi line."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    print(f"[profile] {head} wall {wall:.4f}s under the profiler, device "
          f"kernels {busy:.4f}s ({busy / wall:.0%} busy), {len(kernels)} "
          f"device events ({smi})")
    by = {}
    for e in kernels:
        name = "matrix products (cuBLAS/CUTLASS)" if any(
            m in e.name.lower() for m in _MATMUL) else e.name
        row = by.setdefault(name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] {ms:9.2f} ms {n:6d}x {name[:100]}")
    classes = {}
    for e in kernels:
        row = classes.setdefault(_class_of(e.name), [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] class {ms:9.2f} ms {n:6d}x {name} "
              f"({ms / 1e3 / busy:.1%} of device time)")
    ops = [a for a in prof.key_averages() if a.key.startswith("aten::")
           and a.self_device_time_total > 0]
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:15]:
        print(f"[profile] op {a.self_device_time_total / 1e3:9.2f} ms "
              f"{a.count:6d}x {a.key}")
    print(smi)


if __name__ == "__main__":
    sys.exit(main())
