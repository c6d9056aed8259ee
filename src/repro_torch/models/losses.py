"""Per-sample token cross-entropy (counterpart of
``repro/models/losses.py:22-65``, ``per_sample_xent``).

The training path in plain autograd: logits formed in the compute dtype,
cast to float32, logsumexp minus the correct-class logit. The correct-class
logit is taken with ``gather`` rather than the reference's one-hot einsum:
the value is the same and no (tokens, V) float32 one-hot is built. Labels
of -1 are masked and per-sample counts are clamped to at least 1.

The no-grad scoring path uses ``kernels/xent/ops.py:per_sample_xent_fused``
instead, which never forms the logits.
"""
from __future__ import annotations

from typing import Tuple

import torch


def per_sample_xent(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, *, label_mask_value: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w_out (d, V); labels (B, S) -> (per_sample (B,), mean)."""
    mask = labels != label_mask_value
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logits = (h @ w_out.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, safe[..., None])[..., 0]
    maskf = mask.to(torch.float32)
    total = ((lse - correct) * maskf).sum(dim=-1)
    counts = torch.clamp(maskf.sum(dim=-1), min=1.0)
    per_sample = total / counts
    return per_sample, per_sample.mean()
