"""Plain PyTorch version of the fused score update (same function as the
CUDA kernel in ``csrc/score_update.cu``).

Counterpart of ``repro/kernels/score_update/score_update.py:
fused_score_update`` in masked mode: Eq. (3.1) applied in place and
SEQUENTIALLY over the ids, so a duplicate id sees the earlier occurrence's
update; ids outside ``[0, n)`` are dropped. Every step is a tensor op (no
host sync), so it runs on either device. Used by the CPU path and by the
on-card comparison, never on the main path when a card is present.
"""
from __future__ import annotations

from typing import Tuple

import torch


def score_update_ref(s: torch.Tensor, w: torch.Tensor, seen: torch.Tensor,
                     ids: torch.Tensor, losses: torch.Tensor, *,
                     beta1: float, beta2: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """s, w (n,) f32; seen (n,) i32; ids (B,) int; losses (B,) f32.

    Mutates ``s``, ``w`` and ``seen`` in place and returns them.
    """
    n = s.shape[0]
    losses = losses.to(torch.float32)
    for i in range(ids.shape[0]):
        idx = ids[i:i + 1].long()
        valid = (idx >= 0) & (idx < n)
        pos = torch.where(valid, idx, torch.zeros_like(idx))
        s_prev = s[pos]
        loss = losses[i:i + 1]
        w_new = beta1 * s_prev + (1.0 - beta1) * loss
        s_new = beta2 * s_prev + (1.0 - beta2) * loss
        w[pos] = torch.where(valid, w_new, w[pos])
        s[pos] = torch.where(valid, s_new, s_prev)
        seen[pos] = seen[pos] + valid.to(seen.dtype)
    return s, w, seen
