"""Plain PyTorch versions of the fused score updates (same functions as
the CUDA kernels in ``csrc/score_update.cu`` and
``csrc/quant_score_update.cu``).

Counterparts of ``repro/kernels/score_update/score_update.py:
fused_score_update`` (masked mode) and ``fused_quant_score_update``:
Eq. (3.1) applied in place and SEQUENTIALLY over the ids, so a duplicate
id sees the earlier occurrence's update; ids outside ``[0, n)`` are
dropped. Every step is a tensor op (no
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
