"""Evolved Sampling score state, paper Eq. (3.1) (counterpart of
``repro/core/scores.py:57-161``, ``ReplicatedStore`` :271-302, the int8
``QuantizedStore`` :647-959 and ``make_store`` :1312-1325).

    w_i(t) = beta1 * s_i(t-1) + (1-beta1) * l_i(theta(t))
    s_i(t) = beta2 * s_i(t-1) + (1-beta2) * l_i(theta(t))

The (n,) state is the trainer's only O(n_train) state. Both stores update
it IN PLACE (the fused kernels write the leaves where they lie), so no
step copies it. The port runs the replicated layout only: the sharded
store and the int8 wire raise "not ported yet".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..kernels.score_update.ops import (fused_quant_score_update,
                                        fused_score_update)


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
    """Full (n,) float32 arrays on the one device."""

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


# ---------------------------------------------------------------------------
# QuantizedStore: int8 score state with per-block scales + error feedback
# ---------------------------------------------------------------------------

_QMAX = 127.0


@dataclasses.dataclass
class QuantizedScores:
    """Int8 form of the score triple: codes on a per-block grid (row r uses
    ``*_scale[r // block]``), ``seen_q`` saturating at 127, grow-only f32
    scales, and the error-feedback ring of the most recently updated rows
    (``err_rows`` global ids, -1 empty; ``err_seq`` recency stamps, 0
    empty; ``err_s``/``err_w`` the residuals). A gather returns
    ``code * scale + newest residual``: exact for a row still in the ring,
    within scale/2 after eviction."""
    s_q: torch.Tensor       # (n,) int8
    w_q: torch.Tensor       # (n,) int8
    seen_q: torch.Tensor    # (n,) int8
    s_scale: torch.Tensor   # (n_blocks,) f32
    w_scale: torch.Tensor   # (n_blocks,) f32
    err_rows: torch.Tensor  # (R,) int32
    err_seq: torch.Tensor   # (R,) int32
    err_s: torch.Tensor     # (R,) f32
    err_w: torch.Tensor     # (R,) f32


Scores = Union[ESScores, QuantizedScores]


def _q_init_leaf(rows: int, n_blocks: int, ring: int,
                 device="cuda") -> QuantizedScores:
    """The 1/n prior as code 127 on a (1/n)/127 grid, an empty ring."""
    scale0 = (1.0 / rows) / _QMAX

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return QuantizedScores(
        s_q=full((rows,), 127, torch.int8), w_q=full((rows,), 127, torch.int8),
        seen_q=full((rows,), 0, torch.int8),
        s_scale=full((n_blocks,), scale0, torch.float32),
        w_scale=full((n_blocks,), scale0, torch.float32),
        err_rows=full((ring,), -1, torch.int32),
        err_seq=full((ring,), 0, torch.int32),
        err_s=full((ring,), 0.0, torch.float32),
        err_w=full((ring,), 0.0, torch.float32))


def _q_gather_1d(q: torch.Tensor, scales: torch.Tensor, block: int,
                 err_rows: torch.Tensor, err_seq: torch.Tensor,
                 err_val: torch.Tensor, pos: torch.Tensor,
                 gids: torch.Tensor) -> torch.Tensor:
    """Dequantized values of local rows ``pos``, corrected by the NEWEST
    ring residual whose global id matches ``gids`` (-1 never matches;
    ``argmax`` takes the lowest index among equal stamps, as JAX's)."""
    pos = pos.long()
    deq = q[pos].to(torch.float32) * scales[pos // block]
    hit = err_rows[None, :] == gids[:, None]                 # (B, R)
    stamped = torch.where(hit, err_seq[None, :], torch.zeros_like(err_seq))
    newest = torch.argmax(stamped, dim=1)
    has = stamped.max(dim=1).values > 0
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return deq + torch.where(has, err_val[newest], zero)


def _q_grow_scales(qs: QuantizedScores, pos: torch.Tensor,
                   mask: torch.Tensor, gids: torch.Tensor,
                   losses: torch.Tensor, beta1: float, beta2: float,
                   block: int) -> None:
    """Grow the touched blocks' scales to fit the incoming Eq. (3.1)
    values (grow-only) and re-code the stored int8 onto the new grid, in
    place. The re-code runs every step: a block whose scale did not grow
    has ratio 1 and re-codes exactly, and no host sync decides whether
    any block grew (the reference's ``lax.cond``)."""
    s_prev = _q_gather_1d(qs.s_q, qs.s_scale, block, qs.err_rows,
                          qs.err_seq, qs.err_s, pos, gids)
    w_new = weights_from_prev(s_prev, losses, beta1)
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    blk = pos.long() // block
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    n = qs.s_q.shape[0]
    for q, scale, v in ((qs.s_q, qs.s_scale, s_new),
                        (qs.w_q, qs.w_scale, w_new)):
        need = torch.zeros_like(scale).scatter_reduce(
            0, blk, torch.where(mask, v.abs(), zero) / _QMAX, "amax")
        new = torch.maximum(scale, need)
        ratio = (scale / new).repeat_interleave(block)[:n]   # <= 1
        q.copy_(torch.round(q.to(torch.float32) * ratio).to(torch.int8))
        scale.copy_(new)


def _q_ring_slots(err_seq: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring slots and recency stamps for a batch: the oldest slots are
    recycled, owned entries take the OLDEST of them (masked entries draw
    the sentinel R and the newer candidates, and their writes drop), and
    stamps grow with batch position so duplicates resolve last-wins. Both
    sorts are stable, as ``jnp.argsort``."""
    B, R = mask.shape[0], err_seq.shape[0]
    k = min(B, R)
    dev = err_seq.device
    oldest = torch.argsort(err_seq, stable=True).to(torch.int32)
    base = err_seq.max() + 1
    perm = torch.argsort(mask.to(torch.int32), stable=True)
    by_rank_slot = torch.cat([
        torch.full((B - k,), R, dtype=torch.int32, device=dev),
        oldest[:k].flip(0)])
    by_rank_seq = base + torch.arange(B, dtype=torch.int32, device=dev)
    slots = torch.empty(B, dtype=torch.int32, device=dev)
    seqs = torch.empty(B, dtype=torch.int32, device=dev)
    slots[perm] = by_rank_slot
    seqs[perm] = by_rank_seq
    return slots, seqs


def _q_apply_fixed(qs: QuantizedScores, pos: torch.Tensor,
                   mask: torch.Tensor, gids: torch.Tensor,
                   losses: torch.Tensor, beta1: float, beta2: float,
                   block: int, slots: torch.Tensor,
                   seqs: torch.Tensor) -> QuantizedScores:
    """Fixed-scale dequant -> Eq. (3.1) -> requant + ring write in scatter
    form (``--no-fused-scores``), in place. Every id reads the pre-batch
    state; for duplicate ids the winning write is unspecified on CUDA, as
    in the reference's scatter. Masked entries are dropped."""
    n, R = qs.s_q.shape[0], qs.err_rows.shape[0]
    pos = pos.long()
    blk = pos // block
    ssc, wsc = qs.s_scale[blk], qs.w_scale[blk]
    s_prev = _q_gather_1d(qs.s_q, qs.s_scale, block, qs.err_rows,
                          qs.err_seq, qs.err_s, pos, gids)
    w_new = weights_from_prev(s_prev, losses, beta1)
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    q_s = torch.clamp(torch.round(s_new / ssc), -_QMAX, _QMAX)
    q_w = torch.clamp(torch.round(w_new / wsc), -_QMAX, _QMAX)
    e_s = s_new - q_s * ssc
    e_w = w_new - q_w * wsc
    rows = pos[mask]
    qs.s_q[rows] = q_s[mask].to(torch.int8)
    qs.w_q[rows] = q_w[mask].to(torch.int8)
    adds = torch.bincount(rows, minlength=n).to(torch.int32)
    qs.seen_q.copy_(torch.clamp(qs.seen_q.to(torch.int32) + adds,
                                max=127).to(torch.int8))
    slot = slots.long()
    wr = mask & (slot >= 0) & (slot < R)
    at = slot[wr]
    qs.err_rows[at] = gids[wr].to(torch.int32)
    qs.err_seq[at] = seqs[wr].to(torch.int32)
    qs.err_s[at] = e_s[wr]
    qs.err_w[at] = e_w[wr]
    return qs


def _q_update_local(qs: QuantizedScores, local_ids: torch.Tensor,
                    gids: torch.Tensor, losses: torch.Tensor, beta1: float,
                    beta2: float, block: int,
                    use_kernel: bool) -> QuantizedScores:
    """One full update, in place: mask out-of-range rows, grow the scales,
    assign ring slots, then apply through the kernel (sequential) or the
    scatter form."""
    n = qs.s_q.shape[0]
    losses = losses.to(torch.float32)
    mask = (local_ids >= 0) & (local_ids < n)
    pos = torch.where(mask, local_ids, torch.zeros_like(local_ids))
    mgids = torch.where(mask, gids, torch.full_like(gids, -1))
    _q_grow_scales(qs, pos, mask, mgids, losses, beta1, beta2, block)
    slots, seqs = _q_ring_slots(qs.err_seq, mask)
    if use_kernel:
        lids = torch.where(mask, pos, torch.full_like(pos, -1))
        fused_quant_score_update(
            qs.s_q, qs.w_q, qs.seen_q, qs.s_scale, qs.w_scale, qs.err_rows,
            qs.err_seq, qs.err_s, qs.err_w,
            lids.to(torch.int32).contiguous(),
            mgids.to(torch.int32).contiguous(), losses.contiguous(),
            slots, seqs, beta1=beta1, beta2=beta2, block=block)
        return qs
    return _q_apply_fixed(qs, pos, mask, mgids, losses, beta1, beta2, block,
                          slots, seqs)


@dataclasses.dataclass(frozen=True)
class QuantizedStore:
    """Int8 decorator over the replicated backend: the same store
    protocol with ~4x smaller state (3 int8 rows, per-``block`` scales and
    a ``residual_rows`` error-feedback ring instead of 12 B/row)."""

    inner: ReplicatedStore = dataclasses.field(
        default_factory=ReplicatedStore)
    block: int = 1024           # rows per scale (clamped to n)
    residual_rows: int = 1024   # error-feedback ring size
    wire: bool = False

    def __post_init__(self):
        if self.wire:
            raise NotImplementedError("the int8 wire (--quant-wire) is not "
                                      "ported yet")
        if not isinstance(self.inner, ReplicatedStore):
            raise NotImplementedError("the quantized store over a sharded "
                                      "backend is not ported yet")

    def _block(self, n: int) -> int:
        return min(self.block, n)

    def init_leaf(self, n: int, device="cuda") -> QuantizedScores:
        blk = self._block(n)
        return _q_init_leaf(n, -(-n // blk), self.residual_rows, device)

    def update(self, qs: QuantizedScores, ids: torch.Tensor,
               losses: torch.Tensor, beta1: float, beta2: float, *,
               fused: bool = True) -> QuantizedScores:
        """In place; ``fused`` dispatches to the quantized kernel, else
        the scatter form. Ids outside [0, n) are dropped."""
        return _q_update_local(qs, ids, ids, losses, beta1, beta2,
                               self._block(qs.s_q.shape[0]), fused)

    def gather(self, qs: QuantizedScores, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = qs.s_q.shape[0]
        blk = self._block(n)
        pos = torch.clamp(ids.long(), 0, n - 1)
        s = _q_gather_1d(qs.s_q, qs.s_scale, blk, qs.err_rows, qs.err_seq,
                         qs.err_s, pos, ids)
        w = _q_gather_1d(qs.w_q, qs.w_scale, blk, qs.err_rows, qs.err_seq,
                         qs.err_w, pos, ids)
        return s, w

    def select(self, weights: torch.Tensor, k: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.inner.select(weights, k, generator=generator,
                                 gumbel=gumbel)


Store = Union[ReplicatedStore, QuantizedStore]


def make_store(sharding=None, *, quantize: bool = False, block: int = 1024,
               residual_rows: int = 1024, wire: bool = False) -> Store:
    """The backend for a row layout: the replicated store, wrapped in the
    int8 ``QuantizedStore`` when ``quantize``. A ``sharding`` (the
    sharded store) is not ported yet."""
    if sharding is not None:
        raise NotImplementedError("the sharded score store (--shard-scores) "
                                  "is not ported yet")
    if not quantize:
        return ReplicatedStore()
    return QuantizedStore(ReplicatedStore(), block=block,
                          residual_rows=residual_rows, wire=wire)
