"""Batch construction for the model zoo (synthetic token pipeline), and
the dry run's input specs (no allocation).

Counterpart of ``repro/data/batches.py``.  ``make_train_batch`` draws the
same numpy ``default_rng`` streams, so a seed gives the reference's tokens
and labels.  ``train_input_specs`` and ``decode_token_spec`` stand in for
the reference's ``ShapeDtypeStruct``s: tensors on the ``meta`` device,
which have a shape and a dtype and no storage.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DTYPES, DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig, ShapeSpec


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Real (allocated) batch on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1  # no target for final position
    out = {"tokens": torch.from_numpy(tokens).to(dev),
           "labels": torch.from_numpy(labels).to(dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model))).to(
                dev, DTYPES[cfg.dtype])
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.n_frontend_tokens,
                                 cfg.d_model))).to(dev, DTYPES[cfg.dtype])
    return out


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec
                      ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for every train/prefill input: tokens and labels
    (B, S) int32, encdec's ``frames`` (B, S, D) and vlm's ``patches`` (B,
    n_frontend_tokens, D) in ``cfg.dtype``."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs = {"tokens": spec((b, s), torch.int32),
             "labels": spec((b, s), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = spec((b, s, cfg.d_model), DTYPES[cfg.dtype])
    if cfg.family == "vlm":
        specs["patches"] = spec((b, cfg.n_frontend_tokens, cfg.d_model),
                                DTYPES[cfg.dtype])
    return specs


def decode_token_spec(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    """A ``meta`` (B, 1) int32 tensor: one decode step's tokens."""
    return torch.empty((shape.global_batch, 1), dtype=torch.int32,
                       device="meta")
