"""Architecture registry: ``--arch <id>`` resolution (copy of
``repro/configs/registry.py``).

The dense architectures are copied here with their exact published
hyper-parameters and smoke configs. Every other id of the JAX registry
resolves to ``NotImplementedError``: its family is not ported yet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "llama3-8b": "llama3_8b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "qwen2-72b": "qwen2_72b",
}
# ids of the JAX registry whose family the port does not run yet
_NOT_PORTED: Dict[str, str] = {
    "zamba2-2.7b": "hybrid",
    "mamba2-780m": "ssm",
    "seamless-m4t-large-v2": "encdec",
    "grok-1-314b": "moe",
    "arctic-480b": "moe",
    "llama-3.2-vision-11b": "vlm",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES) + list(_NOT_PORTED)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is family {_NOT_PORTED[name]!r}, not ported yet; "
            f"the PyTorch port runs {list(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
