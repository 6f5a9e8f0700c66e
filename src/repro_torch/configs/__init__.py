"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, input_specs

# In the reference's registry order (``repro/configs/__init__.py``).
_ARCH_MODULES = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.reduced() if reduced else mod.config()


def list_configs() -> list[ModelConfig]:
    return [get_config(n) for n in ARCH_NAMES]


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeSpec", "get_config", "input_specs",
           "list_configs"]
