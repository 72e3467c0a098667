"""Configurations of the port.

``progressive_retrieval.PipelineConfig`` is the pipeline the paper deploys,
with its serving profiles.  The architecture registry below is the
counterpart of ``repro/configs/__init__.py``: one module per assigned arch
(copies of the reference's, as data), each with its exact public config and
a reduced smoke config (same family, tiny dims) for CPU tests.

Usage: ``repro_torch.configs.get("qwen2.5-14b")`` / ``get_reduced(...)``;
every config builds and trains (``repro_torch.models.transformer``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "gemma3-1b": "gemma3_1b",
    "qwen2.5-14b": "qwen2_5_14b",
    "internlm2-1.8b": "internlm2_1_8b",
    "glm4-9b": "glm4_9b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "phi-3-vision-4.2b": "phi3_vision",
}


def names() -> List[str]:
    return list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {names()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.config()


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.reduced_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get(n) for n in names()}
