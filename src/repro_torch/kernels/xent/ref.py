"""Plain PyTorch version of the fused cross-entropy kernel
(``csrc/xent.cu``).

It mirrors ``repro/kernels/xent/xent.py:fused_xent``: the logits are
float32, formed from the float32 values of h and W. W is the (V, d)
embedding table as stored (the JAX kernel took its (d, V) transpose).
Used by the CPU path and by the on-card comparison.
"""
from __future__ import annotations

import torch


def xent_ref(h: torch.Tensor, w: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """h (M, d); w (V, d); labels (M,) in [0, V) -> per-token nll (M,) f32."""
    logits = h.float() @ w.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - correct
