"""Wrapper of the flash-attention kernel (``csrc/flash_attn.cu``).

Counterpart of ``repro/kernels/flash_attn/ops.py:gqa_flash_attention``,
with the same (B, S, H, hd) layout at the public function. A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises. K and V are read through the kv-head index h // G, never repeated.
"""
from __future__ import annotations

import torch

from .._build import check, library
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention: tensors on {q.device}, the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("gqa_flash_attention: q, k, v on different devices")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"gqa_flash_attention: {name} is {x.dtype}, "
                             f"the kernel takes bfloat16")
        if x.ndim != 4 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"gqa_flash_attention: {name} must be a "
                             f"contiguous, 16-byte aligned 4-D tensor")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"gqa_flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"gqa_flash_attention: {H} query heads over "
                         f"{k.shape[2]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gqa_flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, K, hd), H = G*K -> (B, S, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    _validate(q, k, v)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attn_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            k.shape[2], hd, int(causal), 1.0 / hd ** 0.5, stream)
    check(err, "repro_flash_attn_bf16")
    gqa_flash_attention.launches += 1
    return o


gqa_flash_attention.launches = 0
