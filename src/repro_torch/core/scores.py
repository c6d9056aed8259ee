"""Evolved Sampling score state, paper Eq. (3.1) (counterpart of
``repro/core/scores.py:57-161`` and ``ReplicatedStore`` :271-302).

    w_i(t) = beta1 * s_i(t-1) + (1-beta1) * l_i(theta(t))
    s_i(t) = beta2 * s_i(t-1) + (1-beta2) * l_i(theta(t))

The (n,) triple is the trainer's only O(n_train) state. The store updates
it IN PLACE (the fused kernel writes ``s``, ``w`` and ``seen`` where they
lie), so no step copies it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.score_update.ops import fused_score_update


@dataclasses.dataclass
class ESScores:
    """s: EMA of losses; w: sampling weights; seen: times scored."""
    s: torch.Tensor      # (n,) f32
    w: torch.Tensor      # (n,) f32
    seen: torch.Tensor   # (n,) i32


def init_scores(n: int, device="cuda") -> ESScores:
    """The 1/n prior for every row, never seen."""
    return ESScores(s=torch.full((n,), 1.0 / n, dtype=torch.float32,
                                 device=device),
                    w=torch.full((n,), 1.0 / n, dtype=torch.float32,
                                 device=device),
                    seen=torch.zeros((n,), dtype=torch.int32, device=device))


def weights_from_prev(s_prev: torch.Tensor, losses: torch.Tensor,
                      beta1: float) -> torch.Tensor:
    """Eq. (3.1) first line from the pre-update s: the one weight rule."""
    return beta1 * s_prev + (1.0 - beta1) * losses.to(torch.float32)


def update_scores(scores: ESScores, sample_ids: torch.Tensor,
                  losses: torch.Tensor, beta1: float,
                  beta2: float) -> ESScores:
    """The scatter form of the update (``--no-fused-scores``), in place.

    Ids outside ``[0, n)`` are dropped. For duplicate ids the last write
    wins, computed from the ORIGINAL s (the reference's scatter); the
    fused kernel applies duplicates in sequence instead.
    """
    n = scores.s.shape[0]
    losses = losses.to(torch.float32)
    ids = sample_ids.long()
    keep = (ids >= 0) & (ids < n)
    ids, losses = ids[keep], losses[keep]
    s_prev = scores.s[ids]
    w_new = weights_from_prev(s_prev, losses, beta1)
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    scores.s[ids] = s_new
    scores.w[ids] = w_new
    scores.seen.index_put_((ids,), torch.ones_like(ids, dtype=torch.int32),
                           accumulate=True)
    return scores


class ReplicatedStore:
    """Full (n,) arrays on the one device: the port's only backend so far."""

    def init_leaf(self, n: int, device="cuda") -> ESScores:
        return init_scores(n, device)

    def update(self, scores: ESScores, ids: torch.Tensor,
               losses: torch.Tensor, beta1: float, beta2: float, *,
               fused: bool = True) -> ESScores:
        """Eq. (3.1) in place; ``fused`` dispatches to the kernel, which
        drops ids outside [0, n) like the scatter path."""
        if fused:
            fused_score_update(scores.s, scores.w, scores.seen,
                               ids.to(torch.int32).contiguous(),
                               losses.to(torch.float32).contiguous(),
                               beta1=beta1, beta2=beta2)
            return scores
        return update_scores(scores, ids, losses, beta1, beta2)

    def gather(self, scores: ESScores, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = ids.long()
        return scores.s[ids], scores.w[ids]

    def select(self, weights: torch.Tensor, k: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        from .selection import gumbel_topk_select
        return gumbel_topk_select(weights, k, generator=generator,
                                  gumbel=gumbel)
