"""LR schedules as functions step -> scale in [0, 1] (counterpart of
``repro/optim/schedule.py``), computed in float32 like the reference."""
from __future__ import annotations

from typing import Callable

import numpy as np

_F = np.float32


def constant() -> Callable[[int], float]:
    return lambda step: 1.0


def warmup_cosine(total_steps: int, warmup_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        s = _F(step)
        warm = s / _F(max(warmup_steps, 1))
        prog = (s - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
        prog = np.clip(prog, _F(0), _F(1))
        cos = _F(final_frac) + _F(1 - final_frac) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return float(warm if s < warmup_steps else cos)
    return fn


def onecycle(total_steps: int, pct_start: float = 0.3) -> Callable[[int], float]:
    up = max(1, int(total_steps * pct_start))

    def fn(step: int) -> float:
        s = _F(step)
        ramp = s / _F(up)
        prog = np.clip((s - _F(up)) / _F(max(total_steps - up, 1)),
                       _F(0), _F(1))
        down = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * prog))
        return float(ramp if s < up else down)
    return fn


def warmup_poly(total_steps: int, warmup_steps: int, power: float = 1.0,
                final_frac: float = 0.0) -> Callable[[int], float]:
    def fn(step: int) -> float:
        s = _F(step)
        warm = s / _F(max(warmup_steps, 1))
        prog = np.clip((s - _F(warmup_steps))
                       / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        poly = _F(final_frac) + _F(1 - final_frac) * (_F(1) - prog) ** _F(power)
        return float(warm if s < warmup_steps else poly)
    return fn


def get_schedule(name: str, total_steps: int,
                 warmup_steps: int = 0) -> Callable[[int], float]:
    if name == "constant":
        return constant()
    if name == "cosine":
        return warmup_cosine(total_steps, warmup_steps)
    if name == "onecycle":
        return onecycle(total_steps)
    if name == "poly":
        return warmup_poly(total_steps, warmup_steps)
    raise ValueError(name)
