"""Mask-based outlier management (paper §V-A).

Copy of ``repro/core/masks.py``: points whose values make QoI bounds blow
up (e.g. Vx=Vy=Vz=0 under the sqrt in Vtotal) are recorded in a bitmap at
refactor time, stored losslessly, and excluded from the error estimation.
The bitmap and values stay numpy (they are archive data);
``OutlierMask.apply`` works on a tensor, on its device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch


@dataclass
class OutlierMask:
    """Bitmap of exactly-stored points for one variable."""
    mask: np.ndarray            # bool, True = outlier (stored exactly)
    values: np.ndarray          # the exact values at masked positions
    _device_copies: dict = field(default_factory=dict, repr=False,
                                 compare=False)

    @property
    def nbytes(self) -> int:
        # 1 bit per element for the bitmap + exact values.
        return (self.mask.size + 7) // 8 + self.values.nbytes

    def on(self, device: torch.device):
        """(mask, values) as tensors on ``device``, copied there once."""
        if device not in self._device_copies:
            self._device_copies[device] = (
                torch.from_numpy(self.mask).to(device),
                torch.from_numpy(self.values).to(device))
        return self._device_copies[device]

    def apply(self, data: torch.Tensor) -> torch.Tensor:
        """Overwrite masked positions of ``data`` with the exact values, on
        ``data``'s device."""
        mask, values = self.on(data.device)
        out = data.clone()
        out[mask] = values
        return out


def build_zero_velocity_mask(fields: Dict[str, np.ndarray],
                             names: Sequence[str] = ("Vx", "Vy", "Vz"),
                             atol: float = 0.0) -> Dict[str, OutlierMask]:
    """Mask points where all velocity components are (near) zero — these are
    wall/boundary nodes in the GE data whose tiny reconstructed values would
    make the sqrt bound (Thm 2) arbitrarily loose."""
    present = [n for n in names if n in fields]
    if not present:
        return {}
    zero = np.ones_like(np.asarray(fields[present[0]], dtype=bool))
    for n in present:
        zero &= np.abs(np.asarray(fields[n])) <= atol
    return {n: OutlierMask(mask=zero.copy(), values=np.asarray(fields[n])[zero])
            for n in present}
