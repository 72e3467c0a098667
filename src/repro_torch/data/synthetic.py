"""Synthetic stand-ins for the paper's datasets (Table III): copy of
``repro/data/synthetic.py`` (numpy, seeded, bit-equal to it).

The real GE/NYX/Hurricane/S3D files are not available offline, so the
fields carry the structural properties the experiments depend on: smooth
multi-scale variation (so multilevel coefficients decay and bitplanes
compress), physically plausible positive pressure, density and
temperature, a fraction of exact-zero velocity nodes (wall boundaries —
exercising the outlier mask), and species concentrations spanning decades
(S3D).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def smooth_field(shape: Tuple[int, ...], seed: int, octaves: int = 5,
                 lo: float = -1.0, hi: float = 1.0,
                 roughness: float = 0.55) -> np.ndarray:
    """Sum of random low-frequency separable cosines — a cheap multi-scale
    'simulation-like' field with spectral decay."""
    rng = np.random.default_rng(seed)
    coords = [np.linspace(0.0, 1.0, n) for n in shape]
    out = np.zeros(shape, dtype=np.float64)
    amp = 1.0
    for o in range(octaves):
        freq = 2.0 ** o
        term = amp * np.ones(shape)
        for ax, c in enumerate(coords):
            phase = rng.uniform(0, 2 * np.pi)
            f = freq * rng.uniform(0.6, 1.4)
            wave = np.cos(2 * np.pi * f * c + phase)
            sl = [None] * len(shape)
            sl[ax] = slice(None)
            term = term * wave[tuple(sl)]
        out += term
        amp *= roughness
    out += 0.002 * rng.standard_normal(shape)  # measurement-scale noise
    omin, omax = out.min(), out.max()
    return lo + (hi - lo) * (out - omin) / (omax - omin)


def ge_like_fields(n: int = 1 << 16, seed: int = 0,
                   zero_fraction: float = 0.02) -> Dict[str, np.ndarray]:
    """GE CFD-like: Vx, Vy, Vz, P, D on a linearised (1D) unstructured mesh.
    A contiguous 'wall' region has exactly-zero velocity (outlier-mask case).
    """
    rng = np.random.default_rng(seed + 1000)
    fields = {
        "Vx": smooth_field((n,), seed + 1, lo=-250.0, hi=320.0),
        "Vy": smooth_field((n,), seed + 2, lo=-180.0, hi=260.0),
        "Vz": smooth_field((n,), seed + 3, lo=-90.0, hi=140.0),
        # pressure ~ [3e4, 1.2e5] Pa, density ~ [0.4, 1.6] kg/m3
        "P": smooth_field((n,), seed + 4, lo=3.0e4, hi=1.2e5),
        "D": smooth_field((n,), seed + 5, lo=0.4, hi=1.6),
    }
    n_zero = int(zero_fraction * n)
    if n_zero:
        start = int(rng.integers(0, n - n_zero))
        for v in ("Vx", "Vy", "Vz"):
            fields[v][start:start + n_zero] = 0.0
    return fields


def nyx_like_fields(shape: Tuple[int, int, int] = (33, 33, 33),
                    seed: int = 7) -> Dict[str, np.ndarray]:
    """NYX/Hurricane-like: 3D velocity components for total-velocity QoI."""
    return {
        "Vx": smooth_field(shape, seed + 1, lo=-3.2e7, hi=3.4e7),
        "Vy": smooth_field(shape, seed + 2, lo=-2.8e7, hi=3.1e7),
        "Vz": smooth_field(shape, seed + 3, lo=-3.0e7, hi=2.9e7),
    }


def s3d_like_fields(shape: Tuple[int, int, int] = (33, 33, 17),
                    seed: int = 13) -> Dict[str, np.ndarray]:
    """S3D-like: 8 species molar concentrations (positive, decades of scale);
    QoIs are pairwise multiplications (rate-of-progress intermediates)."""
    names = ["H2", "O2", "H2O", "H", "O", "OH", "HO2", "H2O2"]
    out = {}
    for i, nm in enumerate(names):
        base = smooth_field(shape, seed + i, lo=0.0, hi=1.0)
        scale = 10.0 ** (-2.0 * (i % 4))  # decades of magnitude
        out[f"x{i}"] = (1e-8 + base) * scale
        out[nm] = out[f"x{i}"]  # alias by species name too
    return out
