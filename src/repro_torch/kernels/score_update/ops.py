"""Wrappers of the fused score-update kernels (``csrc/score_update.cu``
and ``csrc/quant_score_update.cu``).

Counterparts of ``repro/kernels/score_update/ops.py`` and of the kernel
dispatch in ``repro/core/scores.py:ReplicatedStore.update`` and
``_q_update_local``. A CPU tensor takes the plain version (``ref.py``); a
CUDA tensor launches the kernel or raises. The updates are in place on the
store's leaves: the (n,) store is the trainer's only O(n_train) state and
is never copied.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._build import check, library
from .ref import quant_score_update_ref, score_update_ref


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


_QUANT_LEAVES = (("s_q", torch.int8), ("w_q", torch.int8),
                 ("seen_q", torch.int8), ("s_scale", torch.float32),
                 ("w_scale", torch.float32), ("err_rows", torch.int32),
                 ("err_seq", torch.int32), ("err_s", torch.float32),
                 ("err_w", torch.float32), ("ids", torch.int32),
                 ("gids", torch.int32), ("losses", torch.float32),
                 ("slots", torch.int32), ("seqs", torch.int32))


def _validate_quant(block: int, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_quant_score_update: tensors on {dev}, the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version)")
    for (name, dt), x in zip(_QUANT_LEAVES, tensors):
        if x.device != dev:
            raise ValueError(f"fused_quant_score_update: {name} on "
                             f"{x.device}, s_q on {dev}")
        if x.dtype != dt:
            raise ValueError(f"fused_quant_score_update: {name} is "
                             f"{x.dtype}, needs {dt}")
        if x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"fused_quant_score_update: {name} must be 1-D "
                             f"and contiguous, got shape {tuple(x.shape)}")
    n, R, B = tensors[0].shape[0], tensors[5].shape[0], tensors[9].shape[0]
    if any(x.shape[0] != n for x in tensors[1:3]):
        raise ValueError("fused_quant_score_update: s_q, w_q, seen_q differ "
                         "in shape")
    if any(x.shape[0] != R for x in tensors[6:9]):
        raise ValueError("fused_quant_score_update: ring leaves differ in "
                         "shape")
    if any(x.shape[0] != B for x in tensors[10:]):
        raise ValueError("fused_quant_score_update: ids, gids, losses, "
                         "slots, seqs differ in shape")
    nb = -(-n // block) if block > 0 else 0
    if block <= 0 or tensors[3].shape[0] < nb or tensors[4].shape[0] < nb:
        raise ValueError(f"fused_quant_score_update: block {block} needs "
                         f"{nb} scales for {n} rows")


def fused_quant_score_update(s_q, w_q, seen_q, s_scale, w_scale, err_rows,
                             err_seq, err_s, err_w, ids, gids, losses, slots,
                             seqs, *, beta1: float, beta2: float, block: int
                             ) -> Tuple[torch.Tensor, ...]:
    """Quantized Eq. (3.1) in place, sequential over ``ids`` (LOCAL rows,
    outside [0, n) skipped); ``gids`` are the global ids kept in the ring,
    ``slots``/``seqs`` the precomputed ring slots (>= R drops the
    residual) and stamps. The scales are fixed (the caller runs the grow
    prologue). Returns the 7 mutated leaves (codes, seen, ring)."""
    args = (s_q, w_q, seen_q, s_scale, w_scale, err_rows, err_seq, err_s,
            err_w, ids, gids, losses, slots, seqs)
    if s_q.device.type == "cpu":
        return quant_score_update_ref(*args, beta1=beta1, beta2=beta2,
                                      block=block)
    _validate_quant(block, *args)
    lib = library()
    with torch.cuda.device(s_q.device):
        stream = torch.cuda.current_stream(s_q.device).cuda_stream
        err = lib.repro_quant_score_update(
            *(x.data_ptr() for x in args), s_q.shape[0], ids.shape[0],
            err_rows.shape[0], block,
            float(np.float32(beta1)), float(np.float32(1.0 - beta1)),
            float(np.float32(beta2)), float(np.float32(1.0 - beta2)), stream)
    check(err, "repro_quant_score_update")
    fused_quant_score_update.launches += 1
    return s_q, w_q, seen_q, err_rows, err_seq, err_s, err_w


fused_quant_score_update.launches = 0
