"""Plain PyTorch versions of the fused score updates (same functions as
the CUDA kernels in ``csrc/score_update.cu``, ``csrc/quant_score_update.cu``
and ``csrc/quant_prologue.cu``).

Counterparts of ``repro/kernels/score_update/score_update.py:
fused_score_update`` (masked mode) and ``fused_quant_score_update``:
Eq. (3.1) applied in place and SEQUENTIALLY over the ids, so a duplicate
id sees the earlier occurrence's update; ids outside ``[0, n)`` are
dropped. And of the int8 store's prologue in ``repro/core/scores.py``:
``_q_gather_1d``, ``_q_grow_scales`` and ``_q_ring_slots``. Every step is
a tensor op (no host sync), so it runs on either device; no division
depends on the device (PyTorch on CUDA multiplies by the reciprocal of a
Python-number divisor, so the one constant divisor is a tensor). Used by
the CPU path and by the on-card comparison, never on the main path when a
card is present.
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


def quant_score_update_ref(s_q: torch.Tensor, w_q: torch.Tensor,
                           seen_q: torch.Tensor, s_scale: torch.Tensor,
                           w_scale: torch.Tensor, err_rows: torch.Tensor,
                           err_seq: torch.Tensor, err_s: torch.Tensor,
                           err_w: torch.Tensor, ids: torch.Tensor,
                           gids: torch.Tensor, losses: torch.Tensor,
                           slots: torch.Tensor, seqs: torch.Tensor, *,
                           beta1: float, beta2: float, block: int
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the quantized kernel (``csrc/quant_score_update.cu``;
    reference ``score_update.py:fused_quant_score_update``): for each id in
    sequence, dequantise with the fixed block scale plus the newest ring
    residual of ``gids[i]`` (lowest index among equal stamps), apply
    Eq. (3.1), requantise (round half to even, clip +-127), saturate seen
    at 127 and write the residuals to ring slot ``slots[i]`` when it is
    below R. Ids outside [0, n) are skipped. Mutates the codes, seen and
    the ring in place and returns the 7 mutated leaves."""
    n = s_q.shape[0]
    R = err_rows.shape[0]
    losses = losses.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=s_q.device)
    for i in range(ids.shape[0]):
        idx = ids[i:i + 1].long()
        valid = (idx >= 0) & (idx < n)
        pos = torch.where(valid, idx, torch.zeros_like(idx))
        gid = gids[i:i + 1]
        blk = pos // block
        ssc, wsc = s_scale[blk], w_scale[blk]
        stamped = torch.where(err_rows == gid, err_seq,
                              torch.zeros_like(err_seq))
        newest = torch.argmax(stamped)
        has = stamped.max() > 0
        s_prev = s_q[pos].to(torch.float32) * ssc + torch.where(
            has, err_s[newest], zero)
        loss = losses[i:i + 1]
        w_new = beta1 * s_prev + (1.0 - beta1) * loss
        s_new = beta2 * s_prev + (1.0 - beta2) * loss
        q_s = torch.clamp(torch.round(s_new / ssc), -127.0, 127.0)
        q_w = torch.clamp(torch.round(w_new / wsc), -127.0, 127.0)
        s_q[pos] = torch.where(valid, q_s.to(torch.int8), s_q[pos])
        w_q[pos] = torch.where(valid, q_w.to(torch.int8), w_q[pos])
        seen = torch.clamp(seen_q[pos].to(torch.int32) + 1, max=127)
        seen_q[pos] = torch.where(valid, seen.to(torch.int8), seen_q[pos])
        slot = slots[i:i + 1].long()
        write = valid & (slot >= 0) & (slot < R)
        sl = torch.where(write, slot, torch.zeros_like(slot))
        err_rows[sl] = torch.where(write, gid, err_rows[sl])
        err_seq[sl] = torch.where(write, seqs[i:i + 1], err_seq[sl])
        err_s[sl] = torch.where(write, s_new - q_s * ssc, err_s[sl])
        err_w[sl] = torch.where(write, w_new - q_w * wsc, err_w[sl])
    return s_q, w_q, seen_q, err_rows, err_seq, err_s, err_w


_QMAX = 127.0


def q_gather_1d(q: torch.Tensor, scales: torch.Tensor, block: int,
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


def quant_grow_scales_ref(s_q: torch.Tensor, w_q: torch.Tensor,
                          s_scale: torch.Tensor, w_scale: torch.Tensor,
                          err_rows: torch.Tensor, err_seq: torch.Tensor,
                          err_s: torch.Tensor, ids: torch.Tensor,
                          gids: torch.Tensor, losses: torch.Tensor, *,
                          beta1: float, beta2: float, block: int
                          ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the grow kernel (``csrc/quant_prologue.cu``;
    reference ``repro/core/scores.py:_q_grow_scales``): grow the touched
    blocks' scales to fit the incoming Eq. (3.1) values of the in-range
    ``ids`` (grow-only) and re-code the stored int8 onto the new grid, in
    place. This version re-codes every row: a block whose scale did not
    grow has ratio exactly 1 and re-codes to the same codes, which is what
    lets the kernel (and the reference's ``lax.cond``) skip it. Returns
    the 4 mutated leaves."""
    n = s_q.shape[0]
    losses = losses.to(torch.float32)
    mask = (ids >= 0) & (ids < n)
    pos = torch.where(mask, ids, torch.zeros_like(ids)).long()
    mgids = torch.where(mask, gids, torch.full_like(gids, -1))
    s_prev = q_gather_1d(s_q, s_scale, block, err_rows, err_seq, err_s, pos,
                         mgids)
    w_new = beta1 * s_prev + (1.0 - beta1) * losses
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    blk = pos // block
    zero = torch.zeros((), dtype=torch.float32, device=s_q.device)
    qmax = torch.full((), _QMAX, dtype=torch.float32, device=s_q.device)
    for q, scale, v in ((s_q, s_scale, s_new), (w_q, w_scale, w_new)):
        need = torch.zeros_like(scale).scatter_reduce(
            0, blk, torch.where(mask, v.abs(), zero) / qmax, "amax")
        new = torch.maximum(scale, need)
        ratio = (scale / new).repeat_interleave(block)[:n]   # <= 1
        q.copy_(torch.round(q.to(torch.float32) * ratio).to(torch.int8))
        scale.copy_(new)
    return s_q, w_q, s_scale, w_scale


def quant_ring_slots_ref(err_seq: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ring-slot kernel (``csrc/quant_prologue.cu``;
    reference ``repro/core/scores.py:_q_ring_slots``): ring slots and
    recency stamps for a batch. The oldest slots are recycled, owned
    entries take the OLDEST of them (masked entries draw the sentinel R
    and the newer candidates, and their writes drop), and stamps grow with
    batch position so duplicates resolve last-wins. Both sorts are stable,
    as ``jnp.argsort``."""
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
