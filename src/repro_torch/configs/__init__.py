"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

_ARCH_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.reduced() if reduced else mod.config()


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeSpec", "get_config"]
