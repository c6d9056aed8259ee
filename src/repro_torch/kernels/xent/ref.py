"""Plain PyTorch versions of the fused cross-entropy kernels
(``csrc/xent.cu``).

``xent_ref`` mirrors ``repro/kernels/xent/xent.py:fused_xent``: the logits
are float32, formed from the float32 values of h and W. W is the (V, d)
embedding table as stored (the JAX kernel took its (d, V) transpose).
``xent_partials_ref`` and ``xent_combine_ref`` are the plain versions of
the card's two kernels, which split the vocabulary: per (row, split) the
max logit, the sum of exp(logit - max) and the label's logit, then a fold
over the splits. Used by the CPU path and by the on-card comparison.
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


def xent_partials_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      span: int) -> torch.Tensor:
    """-> (M, n_split, 3) f32 over splits of ``span`` vocab columns
    (n_split = ceil(V / span)): max logit, sum of exp(logit - max), and the
    label's logit (0 where the label lies in another split, or outside
    [0, V): another rank's slice of a split vocabulary)."""
    logits = h.float() @ w.float().t()
    M, V = logits.shape
    n_split = -(-V // span)
    x = torch.nn.functional.pad(logits, (0, n_split * span - V),
                                value=float("-inf")).reshape(M, n_split, span)
    m = x.amax(dim=-1)
    l = torch.exp(x - m[..., None]).sum(dim=-1)
    lab = labels.long()[:, None]
    live = (lab >= 0) & (lab < V)
    lab = torch.where(live, lab, torch.zeros_like(lab))
    c = torch.zeros_like(m).scatter_(
        1, lab // span, logits.gather(1, lab) * live.to(logits.dtype))
    return torch.stack([m, l, c], dim=-1)


def xent_combine_ref(part: torch.Tensor) -> torch.Tensor:
    """(M, n_split, 3) partials -> per-token nll (M,) f32."""
    m = part[..., 0].amax(dim=-1)
    l = (part[..., 1] * torch.exp(part[..., 0] - m[:, None])).sum(dim=-1)
    return m + torch.log(l) - part[..., 2].sum(dim=-1)
