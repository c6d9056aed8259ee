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

On a mesh (reference :27, :118) the vocabulary is split over "vocab":
each rank forms its columns' logits, and the log-sum-exp and the
correct-class logit are summed over the shards (the max all-reduced
first, outside the gradient: the softmax does not depend on it).
The scoring path's kernel takes the split itself
(``per_sample_xent_fused(ctx=...)``). ``last_token_logits`` gathers the
vocabulary for sampling.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.segsum.ops import segment_sum_autograd
from .layers import ShardCtx


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, safe: torch.Tensor,
               ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """h (B, c, d), w (d, V) in h's dtype, labels (B, c) int64 ->
    per-token NLL (B, c) f32. On a mesh w is this rank's (d, V / m)."""
    logits = (h @ w).float()
    if ctx.size("vocab") == 1:
        lse = torch.logsumexp(logits, dim=-1)
        correct = logits.gather(-1, safe[..., None])[..., 0]
        return lse - correct
    lo, n = ctx.local("vocab", w.shape[1] * ctx.size("vocab"))
    m = ctx.all_reduce(logits.detach().amax(dim=-1), "vocab", "max")
    se = ctx.psum(torch.exp(logits - m[..., None]).sum(dim=-1), "vocab")
    t = safe - lo
    mine = (t >= 0) & (t < n)
    c = logits.gather(-1, torch.where(mine, t, torch.zeros_like(t))[..., None])
    correct = ctx.psum(c[..., 0] * mine.to(torch.float32), "vocab")
    return torch.log(se) + m - correct


def _use_chunks(S: int, seq_chunk: int) -> bool:
    return bool(seq_chunk) and S > seq_chunk and S % seq_chunk == 0


def _chunked_nll(h: torch.Tensor, w: torch.Tensor, safe: torch.Tensor,
                 seq_chunk: int, ctx: ShardCtx = ShardCtx()) -> list:
    """Per-token NLL of each ``seq_chunk`` tokens of the sequence; under
    autograd each chunk is recomputed in the backward, so no more than one
    chunk's float32 logits are held at a time."""
    grad = torch.is_grad_enabled()
    out = []
    for lo in range(0, h.shape[1], seq_chunk):
        args = (h[:, lo:lo + seq_chunk], w, safe[:, lo:lo + seq_chunk], ctx)
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
                    label_mask_value: int = -1, ctx: ShardCtx = ShardCtx()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w_out (d, V); labels (B, S) -> (per_sample (B,), mean).
    When ``seq_chunk`` divides S and is smaller, the per-sample sums
    accumulate chunk by chunk, as the reference's scan does. On a mesh
    w_out is this rank's vocabulary columns."""
    safe, mask = _labels(labels, label_mask_value)
    maskf = mask.to(torch.float32)
    w = w_out.to(h.dtype)
    h = ctx.enter(h, "vocab")
    if _use_chunks(h.shape[1], seq_chunk):
        total = torch.zeros(h.shape[0], dtype=torch.float32,
                            device=h.device)
        for i, nll in enumerate(_chunked_nll(h, w, safe, seq_chunk, ctx)):
            m = maskf[:, i * seq_chunk:(i + 1) * seq_chunk]
            total = total + (nll * m).sum(dim=-1)
    else:
        total = (_chunk_nll(h, w, safe, ctx) * maskf).sum(dim=-1)
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


def last_token_logits(h_last: torch.Tensor, w_out: torch.Tensor,
                      ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """h_last (B, 1, d), w_out (d, V) -> (B, V) float32 logits for
    sampling: the product in h's dtype, then cast; on a mesh each rank's
    vocabulary columns, all-gathered."""
    logits = (h_last[:, 0] @ w_out.to(h_last.dtype)).float()
    return ctx.all_gather(logits, "vocab", 1)
