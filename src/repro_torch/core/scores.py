"""Evolved Sampling score state, paper Eq. (3.1) (counterpart of
``repro/core/scores.py:57-161``, the store protocol's ``prune_epoch``
:222-236, ``ReplicatedStore`` :271-309, the int8 ``QuantizedStore``
:647-1097 and ``make_store`` :1312-1325).

    w_i(t) = beta1 * s_i(t-1) + (1-beta1) * l_i(theta(t))
    s_i(t) = beta2 * s_i(t-1) + (1-beta2) * l_i(theta(t))

The (n,) state is the trainer's only O(n_train) state. Both stores update
it IN PLACE (the fused kernels write the leaves where they lie), so no
step copies it. The port runs the replicated layout only: the sharded
store and the int8 wire raise "not ported yet".

Set-level pruning reads the store on the host once an epoch:
``prune_snapshot`` copies the leaves to numpy (the store's only device →
host transfer, after a device sync) and ``prune_epoch`` runs
``core.pruning`` on that snapshot.

``grow(scores, n_new)`` (the online service's admission, reference
:239-322 and :1131-1182) extends a store by ``n_new`` rows on its device:
the old rows bitwise, the new ones at the 1/n' prior, never seen. It
synchronises the device first, as the snapshot does: pipelined ES leaves
the last store writes on the scoring stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.score_update.ops import (fused_quant_score_update,
                                        fused_score_update,
                                        quant_grow_scales, quant_ring_slots)
from ..kernels.score_update.ref import q_gather_1d as _q_gather_1d
from .pruning import (PruneResult, PruneSnapshot, QuantPruneSnapshot,
                      prune_epoch_snapshot)


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


def _settle(t: torch.Tensor) -> None:
    """Wait for every stream's pending work on ``t``'s device (a no-op on
    the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _check_grow(n_new: int) -> None:
    if n_new <= 0:
        raise ValueError(f"grow needs n_new > 0, got {n_new}")


def _host(*tensors: torch.Tensor) -> list:
    """Numpy copies of ``tensors``. On CUDA the device is synchronised
    first: pipelined ES leaves the store's and the cadence's last writes
    on two streams, and a copy on the default stream alone could read the
    store before the scoring stream's update."""
    _settle(tensors[0])
    return [t.to("cpu", copy=True).numpy() for t in tensors]


class _HostPrune:
    """The store protocol's host side: one ``prune_epoch`` over any
    store's ``prune_snapshot``."""

    def prune_epoch(self, method: str, rng: np.random.Generator, scores, *,
                    prev_losses: Optional[np.ndarray] = None,
                    ratio: float = 0.2, ucb_c: float = 1.0,
                    ka_tau: float = 1.0
                    ) -> Tuple[PruneResult, np.ndarray]:
        """Set-level kept-set for the next epoch -> (PruneResult, s_full),
        ``s_full`` being the (n,) s-EMA snapshot the trainer keeps as
        ``prev_epoch_losses``."""
        snap = self.prune_snapshot(scores)
        res = prune_epoch_snapshot(method, rng, snap,
                                   prev_losses=prev_losses, ratio=ratio,
                                   ucb_c=ucb_c, ka_tau=ka_tau)
        return res, snap.full_losses()


class ReplicatedStore(_HostPrune):
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

    def prune_snapshot(self, scores: ESScores) -> PruneSnapshot:
        """The whole store as one host block."""
        w, s, seen = _host(scores.w, scores.s, scores.seen)
        return PruneSnapshot(weights=[w], losses=[s], seen=[seen],
                             offsets=np.asarray([0], np.int64),
                             n=int(scores.s.shape[0]))

    def grow(self, scores: ESScores, n_new: int
             ) -> Tuple["ReplicatedStore", ESScores]:
        """-> (store, a new leaf of n + ``n_new`` rows): the old rows
        bitwise, the new ones at the 1/n' prior with ``seen`` 0."""
        _check_grow(n_new)
        _settle(scores.s)
        n_tot = int(scores.s.shape[0]) + int(n_new)
        prior = torch.full((n_new,), 1.0 / n_tot, dtype=torch.float32,
                           device=scores.s.device)
        return self, ESScores(
            s=torch.cat([scores.s, prior]), w=torch.cat([scores.w, prior]),
            seen=torch.cat([scores.seen, torch.zeros(
                n_new, dtype=torch.int32, device=scores.seen.device)]))

    def checkpoint_spec(self) -> dict:
        """The backend's provenance in a checkpoint's manifest."""
        return {"kind": "replicated"}


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
    """One full update, in place: grow the scales (and re-code the blocks
    that grew), assign ring slots, then apply through the kernel
    (sequential) or the scatter form. Rows outside [0, n) are masked. On a
    CUDA store the grow, the slots and the kernel apply are one launch
    each and nothing here is O(n); the scatter form stays PyTorch."""
    n = qs.s_q.shape[0]
    ids = local_ids.to(torch.int32).contiguous()
    gids = gids.to(torch.int32).contiguous()
    losses = losses.to(torch.float32).contiguous()
    quant_grow_scales(qs.s_q, qs.w_q, qs.s_scale, qs.w_scale, qs.err_rows,
                      qs.err_seq, qs.err_s, ids, gids, losses, beta1=beta1,
                      beta2=beta2, block=block)
    slots, seqs = quant_ring_slots(qs.err_seq, ids, n)
    if use_kernel:
        # out-of-range ids are skipped by the kernel; gids are read only
        # for in-range ones
        fused_quant_score_update(
            qs.s_q, qs.w_q, qs.seen_q, qs.s_scale, qs.w_scale, qs.err_rows,
            qs.err_seq, qs.err_s, qs.err_w, ids, gids, losses, slots, seqs,
            beta1=beta1, beta2=beta2, block=block)
        return qs
    mask = (ids >= 0) & (ids < n)
    pos = torch.where(mask, ids, torch.zeros_like(ids))
    mgids = torch.where(mask, gids, torch.full_like(gids, -1))
    return _q_apply_fixed(qs, pos, mask, mgids, losses, beta1, beta2, block,
                          slots, seqs)


def _dequant_blocks_host(q_blocks, scale_blocks, block: int, ring,
                         offsets) -> list:
    """Host dequant of int8 row blocks, then the ring's residuals applied
    in recency order (``err_seq``; 0 = empty slot). Rows outside the
    blocks are ignored. The reference's host arithmetic, step for step
    (``repro/core/scores.py:1047-1071``)."""
    rows_all, seq_all, val_all = ring
    order = np.argsort(seq_all, kind="stable")
    rows_o, seq_o, val_o = (rows_all[order], seq_all[order],
                            val_all[order])
    live = seq_o > 0
    rows_o, val_o = rows_o[live], val_o[live]
    out = []
    for q, sc, off in zip(q_blocks, scale_blocks, offsets):
        L = len(q)
        nb = len(sc)
        blk = -(-L // nb) if nb else block
        pad = nb * blk - L
        deq = (np.pad(q.astype(np.float32), (0, pad)).reshape(nb, blk)
               * sc[:, None]).reshape(-1)[:L]
        here = (rows_o >= off) & (rows_o < off + L)
        for r, v in zip(rows_o[here], val_o[here]):
            deq[r - off] = deq[r - off] + v
        out.append(deq)
    return out


@dataclasses.dataclass(frozen=True)
class QuantizedStore(_HostPrune):
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

    def prune_snapshot(self, qs: QuantizedScores) -> QuantPruneSnapshot:
        """Residual-corrected dequants of ``s`` and ``w`` as one host block,
        with the raw codes and scales beside them."""
        n = qs.s_q.shape[0]
        blk = self._block(n)
        s_q, w_q, seen_q, s_sc, w_sc, rows, seq, err_s, err_w = _host(
            qs.s_q, qs.w_q, qs.seen_q, qs.s_scale, qs.w_scale, qs.err_rows,
            qs.err_seq, qs.err_s, qs.err_w)
        offs = [0]
        losses = _dequant_blocks_host([s_q], [s_sc], blk,
                                      (rows, seq, err_s), offs)
        weights = _dequant_blocks_host([w_q], [w_sc], blk,
                                       (rows, seq, err_w), offs)
        return QuantPruneSnapshot(
            weights=weights, losses=losses,
            seen=[seen_q.astype(np.int32)],
            offsets=np.asarray(offs, np.int64), n=int(n),
            q_losses=[s_q], q_scales=[s_sc], q_block=blk)

    def grow(self, qs: QuantizedScores, n_new: int
             ) -> Tuple["QuantizedStore", QuantizedScores]:
        """Grow codes and per-block scales together (the ring keeps its
        rows: their global ids do not move). Old blocks keep codes and
        scales bitwise; new blocks start on the fresh (1/n')/127 grid, and
        a new row in the old partial tail block takes its nearest code on
        that block's scale. A block size that would change across the
        grow (``block`` above the old row count) raises: every old row
        would re-code."""
        _check_grow(n_new)
        _settle(qs.s_q)
        n_old = int(qs.s_q.shape[0])
        n_tot = n_old + int(n_new)
        blk, blk2 = self._block(n_old), self._block(n_tot)
        if blk2 != blk:
            raise ValueError(
                f"quant block changes across grow ({blk} -> {blk2}): "
                f"construct the store with block <= the pre-grow row "
                f"count so block boundaries are stable")
        nb_old, nb_new = -(-n_old // blk), -(-n_tot // blk)
        dev = qs.s_q.device
        scale0 = torch.full((nb_new - nb_old,),
                            float(np.float32((1.0 / n_tot) / _QMAX)),
                            dtype=torch.float32, device=dev)
        s_scale = torch.cat([qs.s_scale, scale0])
        w_scale = torch.cat([qs.w_scale, scale0])
        # the new rows' codes, with the reference's numpy arithmetic, from
        # the scales of the blocks they land in (the old tail and new ones)
        lo = n_old // blk
        new_blk = np.arange(n_old, n_tot, dtype=np.int64) // blk - lo

        def codes(scales: torch.Tensor) -> torch.Tensor:
            sc = scales[lo:].cpu().numpy()
            q = np.clip(np.round((1.0 / n_tot) / sc[new_blk]), -_QMAX,
                        _QMAX).astype(np.int8)
            return torch.from_numpy(q).to(dev)

        return self, dataclasses.replace(
            qs, s_q=torch.cat([qs.s_q, codes(s_scale)]),
            w_q=torch.cat([qs.w_q, codes(w_scale)]),
            seen_q=torch.cat([qs.seen_q, torch.zeros(
                n_new, dtype=torch.int8, device=dev)]),
            s_scale=s_scale, w_scale=w_scale)

    def checkpoint_spec(self) -> dict:
        return {"kind": "quantized", "block": int(self.block),
                "residual_rows": int(self.residual_rows),
                "wire": bool(self.wire),
                "inner": self.inner.checkpoint_spec()}


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
