"""Wrapper of the fused score-update kernel (``csrc/score_update.cu``).

Counterpart of ``repro/kernels/score_update/ops.py`` and of the kernel
dispatch in ``repro/core/scores.py:ReplicatedStore.update``. A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises. The update is in place on ``s``, ``w`` and ``seen``: the (n,) store
is the trainer's only O(n_train) state and is never copied.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._build import check, library
from .ref import score_update_ref


def _validate(s, w, seen, ids, losses) -> None:
    dev = s.device
    if dev.type != "cuda":
        raise ValueError(f"fused_score_update: tensors on {dev}, the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version)")
    for name, x, dt in (("s", s, torch.float32), ("w", w, torch.float32),
                        ("seen", seen, torch.int32), ("ids", ids, torch.int32),
                        ("losses", losses, torch.float32)):
        if x.device != dev:
            raise ValueError(f"fused_score_update: {name} on {x.device}, "
                             f"s on {dev}")
        if x.dtype != dt:
            raise ValueError(f"fused_score_update: {name} is {x.dtype}, "
                             f"needs {dt}")
        if x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"fused_score_update: {name} must be 1-D and "
                             f"contiguous, got shape {tuple(x.shape)}")
    if not (s.shape == w.shape == seen.shape):
        raise ValueError("fused_score_update: s, w, seen differ in shape")
    if ids.shape != losses.shape:
        raise ValueError("fused_score_update: ids and losses differ in shape")


def fused_score_update(s: torch.Tensor, w: torch.Tensor, seen: torch.Tensor,
                       ids: torch.Tensor, losses: torch.Tensor, *,
                       beta1: float, beta2: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. (3.1) in place, sequential over ``ids``; ids outside [0, n)
    are dropped. Returns the mutated ``(s, w, seen)``."""
    if s.device.type == "cpu":
        return score_update_ref(s, w, seen, ids, losses, beta1=beta1,
                                beta2=beta2)
    _validate(s, w, seen, ids, losses)
    lib = library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.repro_score_update(
            s.data_ptr(), w.data_ptr(), seen.data_ptr(), ids.data_ptr(),
            losses.data_ptr(), s.shape[0], ids.shape[0],
            float(np.float32(beta1)), float(np.float32(1.0 - beta1)),
            float(np.float32(beta2)), float(np.float32(1.0 - beta2)), stream)
    check(err, "repro_score_update")
    fused_score_update.launches += 1
    return s, w, seen


fused_score_update.launches = 0
