"""Per-sample and per-segment token cross-entropy (counterpart of
``repro/models/losses.py:22-111``, ``per_sample_xent`` and
``per_segment_xent``).

The training path in plain autograd: logits formed in the compute dtype,
cast to float32, logsumexp minus the correct-class logit. The correct-class
logit is taken with ``gather`` rather than the reference's one-hot einsum:
the value is the same and no (tokens, V) float32 one-hot is built. Labels
of -1 are masked and per-sample counts are clamped to at least 1.

The no-grad scoring path uses ``kernels/xent/ops.py:per_sample_xent_fused``
instead, which never forms the logits. ``per_segment_xent`` (packed rows)
reduces the same per-token NLL to document slots through the segment-sum
kernel's ``autograd.Function``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.segsum.ops import segment_sum_autograd


def _token_nll(h: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor,
               label_mask_value: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (per-token NLL (B, S) f32 with label 0 at masked tokens, live
    mask (B, S) bool)."""
    mask = labels != label_mask_value
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logits = (h @ w_out.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, safe[..., None])[..., 0]
    return lse - correct, mask


def per_sample_xent(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, *, label_mask_value: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w_out (d, V); labels (B, S) -> (per_sample (B,), mean)."""
    nll, mask = _token_nll(h, w_out, labels, label_mask_value)
    maskf = mask.to(torch.float32)
    total = (nll * maskf).sum(dim=-1)
    counts = torch.clamp(maskf.sum(dim=-1), min=1.0)
    per_sample = total / counts
    return per_sample, per_sample.mean()


def per_segment_xent(h: torch.Tensor, w_out: torch.Tensor,
                     labels: torch.Tensor, segment_ids: torch.Tensor, *,
                     max_segments: int, label_mask_value: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document NLL of packed rows.

    h (B, S, d); w_out (d, V); labels, segment_ids (B, S) with segment 0 =
    padding -> ``(per_seg (B, M), counts (B, M))``: the mean NLL over each
    slot's live tokens and their count (0 for an empty slot, whose per_seg
    is 0). Differentiable in h and w_out.
    """
    nll, mask = _token_nll(h, w_out, labels, label_mask_value)
    sums, counts = segment_sum_autograd(
        nll.contiguous(), segment_ids.to(torch.int32).contiguous(),
        mask.contiguous(), max_segments=max_segments)
    return sums / torch.clamp(counts, min=1.0), counts
