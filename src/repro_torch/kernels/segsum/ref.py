"""Plain PyTorch version of the segment-sum kernel (``csrc/segsum.cu``).

Counterpart of ``repro/kernels/segsum/segsum.py:fused_segment_sum`` and of
its oracle ``repro/kernels/segsum/ref.py``: token s of row b adds its NLL
to slot ``segment_ids[b, s] - 1`` when its label is live, so padding
(segment 0) and masked tokens add nothing. Used by the CPU path and by the
on-card comparison.
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
