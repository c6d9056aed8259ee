"""Plain PyTorch versions of the segment-sum kernels (``csrc/segsum.cu``).

Counterpart of ``repro/kernels/segsum/segsum.py:fused_segment_sum`` and of
its oracle ``repro/kernels/segsum/ref.py``: token s of row b adds its NLL
to slot ``segment_ids[b, s] - 1`` when its label is live, so padding
(segment 0) and masked tokens add nothing. ``segment_sum_grad_ref`` is the
gradient of the sums: the oracle's ``jax.grad``. Used by the CPU path and
by the on-card comparison.
"""
from __future__ import annotations

from typing import Tuple

import torch


def segment_sum_ref(nll: torch.Tensor, segment_ids: torch.Tensor,
                    mask: torch.Tensor, *, max_segments: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nll (B, S); segment_ids, mask (B, S) -> (sums, counts), each (B, M)
    float32."""
    slots = torch.arange(1, max_segments + 1, device=segment_ids.device,
                         dtype=segment_ids.dtype)
    sel = (segment_ids[..., None] == slots) & (mask != 0)[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=nll.device)
    sums = torch.where(sel, nll.float()[..., None], zero).sum(dim=1)
    counts = sel.sum(dim=1).to(torch.float32)
    return sums, counts


def segment_sum_grad_ref(grad_sums: torch.Tensor, segment_ids: torch.Tensor,
                         mask: torch.Tensor, *, max_segments: int
                         ) -> torch.Tensor:
    """grad_sums (B, M); segment_ids, mask (B, S) -> grad_nll (B, S):
    ``grad_sums[b, segment_ids[b, s] - 1]`` where the token is live and in
    a slot, 0 elsewhere."""
    M = max_segments
    B = grad_sums.shape[0]
    # column 0 stands for "no slot": padding, masked tokens, ids beyond M
    padded = torch.cat([grad_sums.new_zeros(B, 1), grad_sums], dim=1)
    in_slot = (segment_ids >= 1) & (segment_ids <= M) & (mask != 0)
    col = torch.where(in_slot, segment_ids,
                      torch.zeros_like(segment_ids)).long()
    return padded.gather(1, col)
