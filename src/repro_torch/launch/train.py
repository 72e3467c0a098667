"""End-to-end training driver.

    python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --steps 200 --batch 4 --seq 128 \
        --progressive-ckpt out/ckpt --ckpt-every 25 --grad-compress 8

Counterpart of ``repro/launch/train.py``, with its flags and printed lines:
the model from ``configs/``, AdamW or Adafactor, gradient clipping,
optional bitplane gradient compression (error feedback), asynchronous
progressive checkpoints, restart from the latest one (``--resume``, params
only: fresh optimizer moments and feedback, as in the reference), and
deterministic synthetic data.  Runs on CUDA unless ``--device cpu``; the
step is eager autograd.  Beyond the reference's flags: ``--device``,
and ``--n-layers`` (a config cut to fewer layers at full width).  The
checkpoints' bitplane encode and decode are the B1 and B2 CUDA kernels on
the card; their host entropy stage runs on a pool of processes once the
model is large enough to repay it (``checkpoint.entropy_pool``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.data.batches import make_train_batch
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.train.checkpoint import (
    AsyncCheckpointer, RestoreReport, entropy_pool,
    latest_step, restore_checkpoint,
)
from repro_torch.train.grad_compress import compress_decompress, \
    zeros_like_feedback
from repro_torch.train.optimizer import clip_by_global_norm, make_optimizer
from repro_torch.train.pytree import tree_leaves, tree_map
from repro_torch.train.train_step import value_and_grad


@dataclass
class TrainRun:
    """What one :func:`train` call did.  ``snapshots`` (the host copies the
    checkpointer wrote, by step) and ``restored`` (the restored parameter
    tree, before any step) are kept only when asked for."""
    cfg: ModelConfig
    model: Transformer
    losses: Dict[int, float] = field(default_factory=dict)
    grad_norms: Dict[int, float] = field(default_factory=dict)
    step_seconds: Dict[int, float] = field(default_factory=dict)
    tokens_per_step: int = 0
    seconds: float = 0.0
    restore: Optional[RestoreReport] = None
    restore_seconds: float = 0.0
    restored: Any = None
    saved: List[int] = field(default_factory=list)
    snapshots: Dict[int, Any] = field(default_factory=dict)
    close_seconds: float = 0.0
    peak_bytes: int = 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-compress", type=int, default=0,
                    help="bitplanes for gradient compression (0 = off)")
    ap.add_argument("--progressive-ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--restore-tau", type=float, default=0.0,
                    help="QoI-bounded warm restore tolerance (0 = exact)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the config's depth to this many layers "
                         "(0 = as configured; widths stay)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _assign(model: Transformer, tree) -> None:
    """Copy a tree's leaves into the model's parameters, in leaf order."""
    with torch.no_grad():
        for p, new in zip(tree_leaves(model.tree()), tree_leaves(tree)):
            p.copy_(new.reshape(p.shape).to(p.dtype))


def train(argv=None, keep_snapshots: bool = False) -> TrainRun:
    """Run the driver on ``argv`` (the CLI's flags) and return what it
    did; :func:`main` is this plus an exit code."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = Transformer(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    run = TrainRun(cfg=cfg, model=model,
                   tokens_per_step=args.batch * args.seq)
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    opt_state = opt_init(model.tree())
    fb = zeros_like_feedback(model.tree()) if args.grad_compress else None
    start_step = 0

    pool = entropy_pool(sum(p.numel() for p in model.parameters())) \
        if args.progressive_ckpt else None
    ckpt = AsyncCheckpointer(args.progressive_ckpt, dev, pool) \
        if args.progressive_ckpt else None
    try:
        if args.resume and ckpt and \
                latest_step(args.progressive_ckpt) is not None:
            t0 = time.perf_counter()
            restored, report = restore_checkpoint(
                args.progressive_ckpt, tau_rel=args.restore_tau, device=dev,
                executor=pool)
            _assign(model, restored)
            _sync(dev)
            run.restore_seconds = time.perf_counter() - t0
            run.restore = report
            if keep_snapshots:
                run.restored = tree_map(lambda t: t.detach().clone(),
                                        model.tree())
            del restored
            start_step = report.step + 1
            print(f"[restore] step={report.step} moved="
                  f"{report.bytes_moved / 2**20:.1f}MiB "
                  f"({report.bytes_moved / max(report.bytes_full, 1):.0%} "
                  f"of full)")

        t0 = time.perf_counter()
        for step in range(start_step, args.steps):
            ts = time.perf_counter()
            batch = make_train_batch(cfg, args.batch, args.seq, seed=step,
                                     device=dev)
            loss, _, grads = value_and_grad(cfg, model.tree(), batch)
            if args.grad_compress:
                grads, fb = compress_decompress(grads, fb,
                                                args.grad_compress)
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            new_params, opt_state = opt_update(model.tree(), grads,
                                               opt_state, lr=args.lr)
            del grads
            _assign(model, new_params)
            del new_params
            run.losses[step] = float(loss)
            run.grad_norms[step] = float(gnorm)
            run.step_seconds[step] = time.perf_counter() - ts
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                done = step - start_step + 1
                print(f"step={step} loss={run.losses[step]:.4f} "
                      f"gnorm={run.grad_norms[step]:.3f} "
                      f"tok/s={run.tokens_per_step * done / max(dt, 1e-9):.0f}")
            if ckpt and step % args.ckpt_every == 0:
                ckpt.save(model.tree(), step)
                run.saved.append(step)
                if keep_snapshots:
                    run.snapshots[step] = tree_map(
                        lambda t: t.detach().to("cpu", copy=True),
                        model.tree())
        run.seconds = time.perf_counter() - t0
        if ckpt:
            tc = time.perf_counter()
            ckpt.close()
            run.close_seconds = time.perf_counter() - tc
            ckpt = None
    finally:
        if ckpt:
            ckpt.close()
        if pool is not None:
            pool.shutdown()
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    print(f"done: {args.steps - start_step} steps in "
          f"{run.seconds + run.close_seconds:.1f}s")
    return run


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
