"""Architecture registry: ``--arch <id>`` resolution (copy of
``repro/configs/registry.py``).

Every architecture of the JAX registry is copied here with its exact
published hyper-parameters and smoke config.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from .base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "llama3-8b": "llama3_8b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "qwen2-72b": "qwen2_72b",
    "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-780m": "mamba2_780m",
    "grok-1-314b": "grok1_314b",
    "arctic-480b": "arctic_480b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> List[Tuple[str, ModelConfig]]:
    return [(n, get_config(n)) for n in list_archs()]
