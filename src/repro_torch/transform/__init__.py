"""Multilevel transforms on tensors: hb (hierarchical basis, and ip's
pieces) and ob (L2 projection)."""
from repro_torch.transform.hierarchical import (
    decompose_hb,
    grid_levels,
    level_map,
    pad_to_grid,
    recompose_hb,
    recompose_hb_from,
    unpad,
)
from repro_torch.transform.orthogonal import decompose_ob, recompose_ob

__all__ = [
    "pad_to_grid", "unpad", "grid_levels", "level_map",
    "decompose_hb", "recompose_hb", "recompose_hb_from",
    "decompose_ob", "recompose_ob",
]
