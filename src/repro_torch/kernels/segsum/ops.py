"""Wrapper of the segment-sum kernel (``csrc/segsum.cu``) and its
``autograd.Function``.

Counterpart of ``repro/kernels/segsum/ops.py:segment_sum_fused``. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises. The kernel masks the ragged B and S edges itself, so
nothing is padded. The reference kernel is forward-only; here the packed
training forward differentiates through it, so ``segment_sum_autograd``
wraps it with a plain PyTorch backward:
``grad_nll[b, s] = live[b, s] * grad_sums[b, seg[b, s] - 1]``, 0 where
the token belongs to no slot.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, library, on_device
from .ref import segment_sum_ref

MAX_SEGMENTS = 8   # slot accumulators the kernel keeps in registers


def _validate(nll, segment_ids, mask, max_segments: int) -> None:
    dev = nll.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: tensors on {dev}, the kernel takes "
                         f"CUDA tensors (CPU ones take the plain version)")
    for name, x, dt in (("nll", nll, torch.float32),
                        ("segment_ids", segment_ids, torch.int32),
                        ("mask", mask, torch.bool)):
        if x.device != dev:
            raise ValueError(f"segment_sum: {name} on {x.device}, nll on "
                             f"{dev}")
        if x.dtype != dt:
            raise ValueError(f"segment_sum: {name} is {x.dtype}, needs {dt}")
        if x.ndim != 2 or not x.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be 2-D and "
                             f"contiguous, got shape {tuple(x.shape)}")
    if not (nll.shape == segment_ids.shape == mask.shape):
        raise ValueError("segment_sum: nll, segment_ids and mask differ in "
                         "shape")
    if nll.numel() == 0:
        raise ValueError("segment_sum: empty input")
    if not 1 <= max_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_sum: max_segments={max_segments} outside "
                         f"[1, {MAX_SEGMENTS}]")


def segment_sum(nll: torch.Tensor, segment_ids: torch.Tensor,
                mask: torch.Tensor, *, max_segments: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nll (B, S) f32; segment_ids (B, S) int32; mask (B, S) bool ->
    (sums (B, M), counts (B, M)) float32, M = ``max_segments``."""
    if nll.device.type == "cpu":
        return segment_sum_ref(nll, segment_ids, mask,
                               max_segments=max_segments)
    _validate(nll, segment_ids, mask, max_segments)
    B, S = nll.shape
    sums = torch.empty(B, max_segments, dtype=torch.float32,
                       device=nll.device)
    counts = torch.empty_like(sums)
    lib = library()
    with on_device(nll.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_segment_sum(nll.data_ptr(), segment_ids.data_ptr(),
                                    mask.data_ptr(), sums.data_ptr(),
                                    counts.data_ptr(), B, S, max_segments,
                                    stream)
    check(err, "repro_segment_sum")
    segment_sum.launches += 1
    return sums, counts


segment_sum.launches = 0


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nll, segment_ids, mask, max_segments):
        sums, counts = segment_sum(nll.detach(), segment_ids, mask,
                                   max_segments=max_segments)
        ctx.save_for_backward(segment_ids, mask)
        ctx.max_segments = max_segments
        ctx.mark_non_differentiable(counts)
        return sums, counts

    @staticmethod
    def backward(ctx, grad_sums, _grad_counts):
        segment_ids, mask = ctx.saved_tensors
        M = ctx.max_segments
        B = grad_sums.shape[0]
        # column 0 stands for "no slot": padding and ids beyond M
        padded = torch.cat([grad_sums.new_zeros(B, 1), grad_sums], dim=1)
        in_slot = (segment_ids >= 1) & (segment_ids <= M) & mask
        col = torch.where(in_slot, segment_ids,
                          torch.zeros_like(segment_ids)).long()
        return padded.gather(1, col), None, None, None


def segment_sum_autograd(nll: torch.Tensor, segment_ids: torch.Tensor,
                         mask: torch.Tensor, *, max_segments: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segment_sum`` that back-propagates into ``nll`` (counts carry no
    gradient)."""
    return _SegmentSum.apply(nll, segment_ids, mask, max_segments)
