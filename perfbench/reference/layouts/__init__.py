"""The plain model's layouts, one module each, found by name: the
``layout`` key of a configuration's file, or else its family
(``dense``, ``moe``).  A module gives ``leaf_shapes(cfg)`` (the path,
shape and dtype of every leaf, as the program's step functions read
them), ``init_scale(cfg, path)`` (the scale of a leaf's normal draw, or
``None`` for a leaf of ones) and ``layer(...)`` (one layer in float32).
A family of another layout arrives as a new module here."""
from __future__ import annotations

import importlib


def of(cfg):
    """The layout module of configuration ``cfg``."""
    name = cfg.get("layout") or cfg["family"]
    return importlib.import_module(f"perfbench.reference.layouts.{name}")
