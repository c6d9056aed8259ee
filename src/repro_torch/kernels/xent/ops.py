"""Wrappers of the fused cross-entropy kernel (``csrc/xent.cu``).

Counterparts of ``repro/kernels/xent/ops.py:per_token_xent_fused`` and
``per_sample_xent_fused``, used by the port's no-grad scoring forward.
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises. No padding is needed: the kernel masks the ragged
row and vocab edges itself, and it reads W as the (V, d) table.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, library
from .ref import xent_ref


def _validate(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"fused_xent: tensors on {h.device}, the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version)")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("fused_xent: h, w and labels on different devices")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"fused_xent: h and w must be bfloat16, got "
                         f"{h.dtype} and {w.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"fused_xent: labels must be int32, got "
                         f"{labels.dtype}")
    if h.ndim != 2 or w.ndim != 2 or labels.ndim != 1:
        raise ValueError("fused_xent: needs h (M, d), w (V, d), labels (M,)")
    M, d = h.shape
    if w.shape[1] != d or labels.shape[0] != M:
        raise ValueError(f"fused_xent: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if d % 8:
        raise ValueError(f"fused_xent: d={d} must be a multiple of 8")
    for name, x in (("h", h), ("w", w), ("labels", labels)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_xent: {name} must be contiguous and "
                             f"16-byte aligned")


def fused_xent(h: torch.Tensor, w: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """h (M, d); w (V, d); labels (M,) in [0, V) -> nll (M,) float32."""
    if h.device.type == "cpu":
        return xent_ref(h, w, labels)
    _validate(h, w, labels)
    M, d = h.shape
    nll = torch.empty(M, dtype=torch.float32, device=h.device)
    lib = library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.repro_xent_bf16(h.data_ptr(), w.data_ptr(),
                                  labels.data_ptr(), nll.data_ptr(), M,
                                  w.shape[0], d, stream)
    check(err, "repro_xent_bf16")
    fused_xent.launches += 1
    return nll


fused_xent.launches = 0


def per_sample_xent_fused(h: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, *, label_mask_value: int = -1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w (V, d); labels (B, S) -> (per_sample (B,), mean ())."""
    B, S, d = h.shape
    mask = labels != label_mask_value
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    nll = fused_xent(h.reshape(B * S, d).contiguous(), w,
                     safe.reshape(B * S).to(torch.int32).contiguous())
    nll = nll.reshape(B, S) * mask.to(torch.float32)
    counts = torch.clamp(mask.sum(dim=-1).to(torch.float32), min=1.0)
    per_sample = nll.sum(dim=-1) / counts
    return per_sample, per_sample.mean()
