"""Wrappers of the score-store kernels (``csrc/score_update.cu``,
``csrc/quant_score_update.cu`` and ``csrc/quant_prologue.cu``).

Counterparts of ``repro/kernels/score_update/ops.py`` and of the kernel
dispatch in ``repro/core/scores.py:ReplicatedStore.update`` and
``_q_update_local`` (its XLA prologue included). A CPU tensor takes the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises.
The updates are in place on the store's leaves: the (n,) store is the
trainer's only O(n_train) state and is never copied.

The two sequential updates take at most ``CHUNK`` ids a launch; a longer
batch goes chunk by chunk, in order, on the current stream (on the CPU
through the same loop, into the plain version), which keeps Eq. (3.1)
sequential across chunks.

A ``meta`` tensor follows the card's route and stops short of each
launch (``kernels/_cost.py``): nothing real is mutated. A launch's bytes
are its batch's inputs read once and the store rows it touches read and
written once (the rows of a batch's in-range ids, counted per id).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import dry, on_card_route
from .._build import check, library, on_device
from .._cost import SINKS, nbytes, report
from .ref import (quant_grow_scales_ref, quant_ring_slots_ref,
                  quant_score_update_ref, score_update_ref)

CHUNK = 4096           # ids per launch of the two sequential update kernels
QUANT_MAX_RING = 8192  # ring rows the int8 kernels hold in shared memory


def _betas(beta1: float, beta2: float) -> Tuple[float, ...]:
    """b1, 1-b1, b2, 1-b2 rounded to float32, as the plain versions
    compute them."""
    return tuple(float(np.float32(x)) for x in (beta1, 1.0 - beta1, beta2,
                                                 1.0 - beta2))


def _check_leaves(fn: str, dev: torch.device, named) -> None:
    """Every ``(name, tensor, dtype)`` on ``dev``, of ``dtype``, 1-D and
    contiguous; ``dev`` a CUDA device."""
    if not on_card_route(dev):
        raise ValueError(f"{fn}: tensors on {dev}, the kernel takes CUDA "
                         f"tensors (CPU ones take the plain version)")
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f"{fn}: {name} on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise ValueError(f"{fn}: {name} is {x.dtype}, needs {dt}")
        if x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be 1-D and contiguous, got "
                             f"shape {tuple(x.shape)}")


def _same_length(fn: str, what: str, *tensors) -> None:
    if any(x.shape[0] != tensors[0].shape[0] for x in tensors[1:]):
        raise ValueError(f"{fn}: {what} differ in shape")


def _validate(s, w, seen, ids, losses) -> None:
    _check_leaves("fused_score_update", s.device,
                  (("s", s, torch.float32), ("w", w, torch.float32),
                   ("seen", seen, torch.int32), ("ids", ids, torch.int32),
                   ("losses", losses, torch.float32)))
    _same_length("fused_score_update", "s, w, seen", s, w, seen)
    _same_length("fused_score_update", "ids and losses", ids, losses)


def fused_score_update(s: torch.Tensor, w: torch.Tensor, seen: torch.Tensor,
                       ids: torch.Tensor, losses: torch.Tensor, *,
                       beta1: float, beta2: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. (3.1) in place, sequential over ``ids``; ids outside [0, n)
    are dropped. Returns the mutated ``(s, w, seen)``."""
    on_cpu = s.device.type == "cpu"
    if not on_cpu:
        _validate(s, w, seen, ids, losses)
        lib = None if dry(s) else library()
    for start in range(0, ids.shape[0], CHUNK):
        ids_c = ids[start:start + CHUNK]
        losses_c = losses[start:start + CHUNK]
        if on_cpu:
            score_update_ref(s, w, seen, ids_c, losses_c, beta1=beta1,
                             beta2=beta2)
            continue
        # s, w, seen: 12 bytes a touched row, read and written
        if SINKS:
            report("score_update", 0.0, torch.float32,
                   nbytes(ids_c, losses_c) + 24 * ids_c.shape[0])
        if lib is None:
            continue
        with on_device(s.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.repro_score_update(
                s.data_ptr(), w.data_ptr(), seen.data_ptr(),
                ids_c.data_ptr(), losses_c.data_ptr(), s.shape[0],
                ids_c.shape[0], *_betas(beta1, beta2), stream)
        check(err, "repro_score_update")
        fused_score_update.launches += 1
    return s, w, seen


fused_score_update.launches = 0


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing (``csrc/score_update.cu``): its
    device time is the floor of any launch on the card."""
    lib = library()
    with on_device(device):
        err = lib.repro_empty_launch(torch.cuda.current_stream().cuda_stream)
    check(err, "repro_empty_launch")


# ---------------------------------------------------------------------------
# the int8 store: grow/re-code, ring slots, sequential apply
# ---------------------------------------------------------------------------

def _validate_ring(fn: str, R: int) -> None:
    if not 0 < R <= QUANT_MAX_RING:
        raise ValueError(f"{fn}: a ring of {R} rows; the kernels hold at "
                         f"most {QUANT_MAX_RING} in shared memory")


def _validate_scales(fn: str, n: int, block: int, s_scale, w_scale) -> None:
    nb = -(-n // block) if block > 0 else 0
    if block <= 0 or s_scale.shape[0] < nb or w_scale.shape[0] < nb:
        raise ValueError(f"{fn}: block {block} needs {nb} scales for {n} "
                         f"rows")


def quant_grow_scales(s_q, w_q, s_scale, w_scale, err_rows, err_seq, err_s,
                      ids, gids, losses, *, beta1: float, beta2: float,
                      block: int) -> Tuple[torch.Tensor, ...]:
    """Grow the scales of the blocks that the in-range ``ids`` touch to
    fit their incoming Eq. (3.1) values, from the pre-batch store, and
    re-code the codes of each block whose scale grew; in place. ``gids``
    are the global ids the ring keys on. Returns the 4 mutated leaves
    ``(s_q, w_q, s_scale, w_scale)``."""
    args = (s_q, w_q, s_scale, w_scale, err_rows, err_seq, err_s, ids, gids,
            losses)
    if s_q.device.type == "cpu":
        return quant_grow_scales_ref(*args, beta1=beta1, beta2=beta2,
                                     block=block)
    fn = "quant_grow_scales"
    _check_leaves(fn, s_q.device, zip(
        ("s_q", "w_q", "s_scale", "w_scale", "err_rows", "err_seq", "err_s",
         "ids", "gids", "losses"), args,
        (torch.int8, torch.int8, torch.float32, torch.float32, torch.int32,
         torch.int32, torch.float32, torch.int32, torch.int32,
         torch.float32)))
    _same_length(fn, "s_q, w_q", s_q, w_q)
    _same_length(fn, "ring leaves", err_rows, err_seq, err_s)
    _same_length(fn, "ids, gids, losses", ids, gids, losses)
    _validate_scales(fn, s_q.shape[0], block, s_scale, w_scale)
    if ids.shape[0] == 0:
        return s_q, w_q, s_scale, w_scale
    # the batch, and each id's block (two scales, block codes of s_q and
    # w_q) read and written: at most, as a block re-codes only when its
    # scale grows
    if SINKS:
        report("quant_grow_scales", 0.0, torch.float32,
               nbytes(ids, gids, losses) + ids.shape[0] * 2 * (8 + 2 * block))
    if dry(s_q):
        return s_q, w_q, s_scale, w_scale
    lib = library()
    with on_device(s_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_quant_grow_scales(
            *(x.data_ptr() for x in args), s_q.shape[0], ids.shape[0],
            err_rows.shape[0], block, *_betas(beta1, beta2), stream)
    check(err, "repro_quant_grow_scales")
    quant_grow_scales.launches += 1
    return s_q, w_q, s_scale, w_scale


quant_grow_scales.launches = 0


def quant_ring_slots(err_seq: torch.Tensor, ids: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring slots and stamps of a batch (``ref.quant_ring_slots_ref``);
    the ids in [0, n) are the owned ones. Returns ``(slots, seqs)``,
    (B,) int32 each."""
    if err_seq.device.type == "cpu":
        return quant_ring_slots_ref(err_seq, (ids >= 0) & (ids < n))
    fn = "quant_ring_slots"
    _check_leaves(fn, err_seq.device, (("err_seq", err_seq, torch.int32),
                                       ("ids", ids, torch.int32)))
    _validate_ring(fn, err_seq.shape[0])
    B = ids.shape[0]
    slots = torch.empty(B, dtype=torch.int32, device=ids.device)
    seqs = torch.empty(B, dtype=torch.int32, device=ids.device)
    if B == 0:
        return slots, seqs
    if SINKS:
        report("quant_ring_slots", 0.0, torch.int32,
               nbytes(err_seq, ids, slots, seqs))
    if dry(ids):
        return slots, seqs
    lib = library()
    with on_device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_quant_ring_slots(
            err_seq.data_ptr(), ids.data_ptr(), slots.data_ptr(),
            seqs.data_ptr(), n, B, err_seq.shape[0], stream)
    check(err, "repro_quant_ring_slots")
    quant_ring_slots.launches += 1
    return slots, seqs


quant_ring_slots.launches = 0


_QUANT_LEAVES = (("s_q", torch.int8), ("w_q", torch.int8),
                 ("seen_q", torch.int8), ("s_scale", torch.float32),
                 ("w_scale", torch.float32), ("err_rows", torch.int32),
                 ("err_seq", torch.int32), ("err_s", torch.float32),
                 ("err_w", torch.float32), ("ids", torch.int32),
                 ("gids", torch.int32), ("losses", torch.float32),
                 ("slots", torch.int32), ("seqs", torch.int32))


def _validate_quant(block: int, *tensors) -> None:
    fn = "fused_quant_score_update"
    _check_leaves(fn, tensors[0].device,
                  ((name, x, dt) for (name, dt), x in zip(_QUANT_LEAVES,
                                                          tensors)))
    _same_length(fn, "s_q, w_q, seen_q", *tensors[0:3])
    _same_length(fn, "ring leaves", *tensors[5:9])
    _same_length(fn, "ids, gids, losses, slots, seqs", *tensors[9:])
    _validate_ring(fn, tensors[5].shape[0])
    _validate_scales(fn, tensors[0].shape[0], block, tensors[3], tensors[4])


def fused_quant_score_update(s_q, w_q, seen_q, s_scale, w_scale, err_rows,
                             err_seq, err_s, err_w, ids, gids, losses, slots,
                             seqs, *, beta1: float, beta2: float, block: int
                             ) -> Tuple[torch.Tensor, ...]:
    """Quantized Eq. (3.1) in place, sequential over ``ids`` (LOCAL rows,
    outside [0, n) skipped); ``gids`` are the global ids kept in the ring,
    ``slots``/``seqs`` the ring slots (>= R drops the residual) and stamps
    from ``quant_ring_slots``: the kernel relies on their two properties
    (distinct slots for the owned ids; stamps newer than the ring's and
    growing with position, ``csrc/quant_score_update.cu``). The scales
    are fixed (``quant_grow_scales`` runs before). Returns the 7 mutated
    leaves (codes, seen, ring)."""
    leaves = (s_q, w_q, seen_q, s_scale, w_scale, err_rows, err_seq, err_s,
              err_w)
    batch = (ids, gids, losses, slots, seqs)
    on_cpu = s_q.device.type == "cpu"
    if not on_cpu:
        _validate_quant(block, *leaves, *batch)
        lib = None if dry(s_q) else library()
    for start in range(0, ids.shape[0], CHUNK):
        chunk = [x[start:start + CHUNK] for x in batch]
        if on_cpu:
            quant_score_update_ref(*leaves, *chunk, beta1=beta1, beta2=beta2,
                                   block=block)
            continue
        # the chunk; a touched row's 3 codes and 2 scales read, its codes
        # and ring row (rows, seq, s, w) written
        if SINKS:
            report("quant_score_update", 0.0, torch.float32,
                   nbytes(*chunk) + chunk[0].shape[0] * (3 + 8 + 3 + 16))
        if lib is None:
            continue
        with on_device(s_q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.repro_quant_score_update(
                *(x.data_ptr() for x in leaves + tuple(chunk)), s_q.shape[0],
                chunk[0].shape[0], err_rows.shape[0], block,
                *_betas(beta1, beta2), stream)
        check(err, "repro_quant_score_update")
        fused_quant_score_update.launches += 1
    return s_q, w_q, seen_q, err_rows, err_seq, err_s, err_w


fused_quant_score_update.launches = 0
