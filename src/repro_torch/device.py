"""Device policy and working dtype of the compression stack.

Counterpart of ``repro/_x64.py``: scientific data is float64 and the
error-bound math must not see float32 rounding.  The port states the dtype
explicitly on every tensor it creates (``F64``) instead of changing torch's
process-wide default.
"""
from __future__ import annotations

from typing import Union

import torch

F64 = torch.float64

# dtypes by the names the reference's configs and checkpoints use
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    A CUDA device without CUDA raises ``RuntimeError`` — the port never
    carries on quietly on the CPU; callers that want the CPU (the tests)
    ask for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
