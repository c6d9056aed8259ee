"""Per-sample and per-segment token cross-entropy, and the serving path's
last-token logits (counterpart of ``repro/models/losses.py:22-119``,
``per_sample_xent``, ``per_segment_xent`` and ``last_token_logits``).

The training path in plain autograd: logits formed in the compute dtype,
cast to float32, logsumexp minus the correct-class logit. The correct-class
logit is taken with ``gather`` rather than the reference's one-hot einsum:
the value is the same and no (tokens, V) float32 one-hot is built. Labels
of -1 are masked and per-sample counts are clamped to at least 1.

``seq_chunk`` (``ESConfig.seq_chunk``) splits the sequence as the
reference's ``lax.scan`` does (:46-60, :92-104); each chunk runs under
``torch.utils.checkpoint``, so the backward holds one chunk's float32
logits at a time.

The no-grad scoring path uses ``kernels/xent/ops.py:per_sample_xent_fused``
instead, which never forms the logits. ``per_segment_xent`` (packed rows)
reduces the same per-token NLL to document slots through the segment-sum
kernel's ``autograd.Function``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.segsum.ops import segment_sum_autograd


def _chunk_nll(h: torch.Tensor, w: torch.Tensor,
               safe: torch.Tensor) -> torch.Tensor:
    """h (B, c, d), w (d, V) in h's dtype, labels (B, c) int64 ->
    per-token NLL (B, c) f32."""
    logits = (h @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, safe[..., None])[..., 0]
    return lse - correct


def _use_chunks(S: int, seq_chunk: int) -> bool:
    return bool(seq_chunk) and S > seq_chunk and S % seq_chunk == 0


def _chunked_nll(h: torch.Tensor, w: torch.Tensor, safe: torch.Tensor,
                 seq_chunk: int) -> list:
    """Per-token NLL of each ``seq_chunk`` tokens of the sequence; under
    autograd each chunk is recomputed in the backward, so no more than one
    chunk's float32 logits are held at a time."""
    grad = torch.is_grad_enabled()
    out = []
    for lo in range(0, h.shape[1], seq_chunk):
        args = (h[:, lo:lo + seq_chunk], w, safe[:, lo:lo + seq_chunk])
        out.append(checkpoint(_chunk_nll, *args, use_reentrant=False)
                   if grad else _chunk_nll(*args))
    return out


def _labels(labels: torch.Tensor, label_mask_value: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels with 0 at masked tokens, int64; live mask (B, S) bool)."""
    mask = labels != label_mask_value
    return torch.where(mask, labels, torch.zeros_like(labels)).long(), mask


def per_sample_xent(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, *, seq_chunk: int = 1024,
                    label_mask_value: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w_out (d, V); labels (B, S) -> (per_sample (B,), mean).
    When ``seq_chunk`` divides S and is smaller, the per-sample sums
    accumulate chunk by chunk, as the reference's scan does."""
    safe, mask = _labels(labels, label_mask_value)
    maskf = mask.to(torch.float32)
    w = w_out.to(h.dtype)
    if _use_chunks(h.shape[1], seq_chunk):
        total = torch.zeros(h.shape[0], dtype=torch.float32,
                            device=h.device)
        for i, nll in enumerate(_chunked_nll(h, w, safe, seq_chunk)):
            m = maskf[:, i * seq_chunk:(i + 1) * seq_chunk]
            total = total + (nll * m).sum(dim=-1)
    else:
        total = (_chunk_nll(h, w, safe) * maskf).sum(dim=-1)
    counts = torch.clamp(maskf.sum(dim=-1), min=1.0)
    per_sample = total / counts
    return per_sample, per_sample.mean()


def per_segment_xent(h: torch.Tensor, w_out: torch.Tensor,
                     labels: torch.Tensor, segment_ids: torch.Tensor, *,
                     max_segments: int, seq_chunk: int = 1024,
                     label_mask_value: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document NLL of packed rows.

    h (B, S, d); w_out (d, V); labels, segment_ids (B, S) with segment 0 =
    padding -> ``(per_seg (B, M), counts (B, M))``: the mean NLL over each
    slot's live tokens and their count (0 for an empty slot, whose per_seg
    is 0). Differentiable in h and w_out. With ``seq_chunk`` the per-token
    NLL is formed chunk by chunk and then reduced by one segment sum.
    """
    safe, mask = _labels(labels, label_mask_value)
    w = w_out.to(h.dtype)
    if _use_chunks(h.shape[1], seq_chunk):
        nll = torch.cat(_chunked_nll(h, w, safe, seq_chunk), dim=1)
    else:
        nll = _chunk_nll(h, w, safe)
    sums, counts = segment_sum_autograd(
        nll.contiguous(), segment_ids.to(torch.int32).contiguous(),
        mask.contiguous(), max_segments=max_segments)
    return sums / torch.clamp(counts, min=1.0), counts


def last_token_logits(h_last: torch.Tensor,
                      w_out: torch.Tensor) -> torch.Tensor:
    """h_last (B, 1, d), w_out (d, V) -> (B, V) float32 logits for
    sampling: the product in h's dtype, then cast."""
    return (h_last[:, 0] @ w_out.to(h_last.dtype)).float()
