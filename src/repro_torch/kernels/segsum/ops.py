"""Wrappers of the segment-sum kernels (``csrc/segsum.cu``) and their
``autograd.Function``.

Counterpart of ``repro/kernels/segsum/ops.py:segment_sum_fused``. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises. The kernels mask the ragged B and S edges themselves, so
nothing is padded, and take any ``max_segments >= 1``. The reference kernel
is forward-only; here the packed training forward differentiates through
it, so ``segment_sum_autograd`` pairs it with the gradient kernel
(``segment_sum_grad``): ``grad_nll[b, s] = grad_sums[b, seg[b, s] - 1]``
where the token is live and in a slot, 0 elsewhere.

The host path is one launch per call: the checks compare each tensor once
and sums and counts are two views of one allocation. A ``meta`` tensor
follows the card's route and stops short of the launch
(``kernels/_cost.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import dry, on_card_route
from .._build import check, library, on_device
from .._cost import SINKS, nbytes, report
from .ref import segment_sum_grad_ref, segment_sum_ref

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _validate(fn: str, dev: torch.device, shape, named,
              max_segments: int) -> None:
    """``shape`` a non-empty (B, S), ``max_segments >= 1``, and every
    ``(name, tensor, dtype, want_shape, dense)`` of ``dtype`` and
    ``want_shape`` on the CUDA device ``dev``, contiguous where ``dense``
    (the gradient of the sums may take any strides)."""
    if not on_card_route(dev):
        raise ValueError(f"{fn}: tensors on {dev}, the kernel takes CUDA "
                         f"tensors (CPU ones take the plain version)")
    if len(shape) != 2 or shape[0] * shape[1] == 0:
        raise ValueError(f"{fn}: needs a non-empty (B, S), got "
                         f"{tuple(shape)}")
    if max_segments < 1:
        raise ValueError(f"{fn}: max_segments={max_segments}, needs >= 1")
    for name, x, dt, want, dense in named:
        if (x.device != dev or x.dtype != dt or x.shape != want
                or (dense and not x.is_contiguous())):
            raise ValueError(
                f"{fn}: {name} is {x.dtype} {tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ' (strided)'}, needs {dt} "
                f"{tuple(want)}{' contiguous' if dense else ''} on {dev}")


def segment_sum(nll: torch.Tensor, segment_ids: torch.Tensor,
                mask: torch.Tensor, *, max_segments: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nll (B, S) f32; segment_ids (B, S) int32; mask (B, S) bool ->
    (sums (B, M), counts (B, M)) float32, M = ``max_segments``."""
    dev = nll.device
    if dev.type == "cpu":
        return segment_sum_ref(nll, segment_ids, mask,
                               max_segments=max_segments)
    shape = nll.shape
    _validate("segment_sum", dev, shape,
              (("nll", nll, _F32, shape, True),
               ("segment_ids", segment_ids, _I32, shape, True),
               ("mask", mask, _BOOL, shape, True)), max_segments)
    B, S = shape
    out = torch.empty((2, B, max_segments), dtype=_F32, device=dev)
    if SINKS:
        report("segment_sum", 0.0, _F32, nbytes(nll, segment_ids, mask, out))
    if dry(out):
        return out.unbind(0)
    lib = library()
    with on_device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_segment_sum(
            nll.data_ptr(), segment_ids.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, S, max_segments, stream)
    check(err, "repro_segment_sum")
    segment_sum.launches += 1
    return out.unbind(0)


segment_sum.launches = 0


def segment_sum_grad(grad_sums: torch.Tensor, segment_ids: torch.Tensor,
                     mask: torch.Tensor, *, max_segments: int
                     ) -> torch.Tensor:
    """grad_sums (B, M) f32, any strides; segment_ids (B, S) int32; mask
    (B, S) bool -> grad_nll (B, S) float32."""
    dev = grad_sums.device
    if dev.type == "cpu":
        return segment_sum_grad_ref(grad_sums, segment_ids, mask,
                                    max_segments=max_segments)
    shape = segment_ids.shape
    _validate("segment_sum_grad", dev, shape,
              (("grad_sums", grad_sums, _F32,
                (shape[0], max_segments) if len(shape) == 2 else None,
                False),
               ("segment_ids", segment_ids, _I32, shape, True),
               ("mask", mask, _BOOL, shape, True)), max_segments)
    B, S = shape
    out = torch.empty(shape, dtype=_F32, device=dev)
    if SINKS:
        report("segment_sum_grad", 0.0, _F32,
               nbytes(grad_sums, segment_ids, mask, out))
    if dry(out):
        return out
    lib = library()
    row, col = grad_sums.stride()
    with on_device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_segment_sum_grad(
            grad_sums.data_ptr(), row, col, segment_ids.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, S, max_segments, stream)
    check(err, "repro_segment_sum_grad")
    segment_sum_grad.launches += 1
    return out


segment_sum_grad.launches = 0


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
        return segment_sum_grad(grad_sums, segment_ids, mask,
                                max_segments=ctx.max_segments), None, None, \
            None


def segment_sum_autograd(nll: torch.Tensor, segment_ids: torch.Tensor,
                         mask: torch.Tensor, *, max_segments: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segment_sum`` that back-propagates into ``nll`` through
    ``segment_sum_grad`` (counts carry no gradient)."""
    return _SegmentSum.apply(nll, segment_ids, mask, max_segments)
