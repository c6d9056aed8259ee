"""AdamW and SGD with momentum, by hand (counterpart of
``repro/optim/adamw.py:62-116``; no ``torch.optim``).

State mirrors the parameter dict. The update runs IN PLACE on the
parameters and on ``m``/``v``, under ``torch.no_grad()``: at full width the
parameters, moments and gradients are the bulk of device memory, and an
out-of-place step would hold a second copy of each.

Order of operations as in the reference: clip by global norm first; the
step counter then advances; bias corrections use the step in float32;
AdamW adds ``wd * p`` into the delta; SGD-momentum couples weight decay
into the gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models.transformer import dtype_of, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | sgdm
    lr: float = 3e-4                 # base LR; scaled by schedule(step)
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9            # sgdm
    grad_clip_norm: float = 1.0      # 0 disables
    state_dtype: str = "float32"     # m/v dtype
    compress_grads: bool = False     # int8 + error feedback (see
    #                                  distributed/compression.py)


@dataclasses.dataclass
class OptState:
    step: int                        # optimizer steps taken
    m: Dict                          # first moment / momentum
    v: Optional[Dict]                # second moment (adamw only)


def init_opt_state(cfg: OptConfig, params: Dict) -> OptState:
    dt = dtype_of(cfg.state_dtype)
    m = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    v = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params) \
        if cfg.kind == "adamw" else None
    return OptState(step=0, m=m, v=v)


def global_norm(grads: Dict) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Dict, grads: Dict, state: OptState,
                  lr_scale: float) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place on ``params`` and ``state``.

    ``lr_scale`` is schedule(step). Returns metrics (``grad_norm``).
    """
    metrics = {}
    g_leaves = tree_leaves(grads)
    if cfg.grad_clip_norm > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        g_leaves = [(g.float() * scale).to(g.dtype) for g in g_leaves]
        metrics["grad_norm"] = gnorm
    state.step += 1
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    p_leaves = tree_leaves(params)
    m_leaves = tree_leaves(state.m)

    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        t = np.float32(state.step)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for p, g, m, v in zip(p_leaves, g_leaves, m_leaves,
                              tree_leaves(state.v)):
            g32 = g.float()
            m32 = m.float() * b1 + (1 - b1) * g32
            v32 = v.float() * b2 + (1 - b2) * g32.square()
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
        return metrics

    if cfg.kind == "sgdm":
        for p, g, m in zip(p_leaves, g_leaves, m_leaves):
            g32 = g.float()
            if cfg.weight_decay > 0:
                g32 = g32 + cfg.weight_decay * p.float()
            m32 = m.float() * cfg.momentum + g32
            p.copy_(p.float() - lr * m32)
            m.copy_(m32)
        return metrics

    raise ValueError(cfg.kind)
