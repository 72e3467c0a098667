"""Batch construction for the model zoo (synthetic token pipeline).

Counterpart of ``repro/data/batches.py::make_train_batch``: the same numpy
``default_rng`` streams, so a seed gives the reference's tokens and labels.
The reference's ShapeDtypeStruct specs for its dry run belong to the launch
tools (A13).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DTYPES, DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


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
