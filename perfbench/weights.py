"""Seeded weights in the program's parameter tree, made by the benchmark.

The tree is the layout the program's step functions read, with the
scales of the program's own initialisation, both given by the
configuration's layout module (``perfbench/reference/layouts``).  Every
leaf is one ``torch.randn`` on the device from a generator of its own,
seeded from the run's seed and the leaf's path, so the reference can draw
any leaf again, alone and bit for bit, after the program's state is
freed.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

from perfbench.reference import layouts

Shape = Tuple[int, ...]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    key = "/".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") \
        & ((1 << 63) - 1)


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def leaf_shapes(cfg) -> Dict[str, Tuple[Shape, str]]:
    """Path -> (shape, dtype name) of every leaf, as the configuration's
    layout (``perfbench/reference/layouts``) lays them out."""
    return layouts.of(cfg).leaf_shapes(cfg)


def make_leaf(cfg, seed: int, path: str, device) -> torch.Tensor:
    """One leaf as the run's seed makes it, in its own dtype."""
    fam = layouts.of(cfg)
    shape, dt = fam.leaf_shapes(cfg)[path]
    scale = fam.init_scale(cfg, path)
    if scale is None:
        return torch.ones(shape, dtype=DTYPES[dt], device=device)
    out = torch.randn(shape, generator=generator(device, seed, "w", path),
                      dtype=DTYPES[dt], device=device)
    return out.mul_(scale)


def make_tree(cfg, seed: int, device) -> dict:
    """The whole nested tree of leaves."""
    tree: dict = {}
    for path in leaf_shapes(cfg):
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = make_leaf(cfg, seed, path, device)
    return tree


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Path -> leaf of a nested tree."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, p + "."))
        else:
            out[p] = v
    return out
