"""Wrappers of the fused cross-entropy kernels (``csrc/xent.cu``).

Counterparts of ``repro/kernels/xent/ops.py:per_token_xent_fused`` and
``per_sample_xent_fused``, used by the port's no-grad scoring forward.
On the card one call is two kernels: ``xent_partials`` over (row tile,
vocab split) blocks, then ``xent_combine`` over the splits; the split
count comes from ``vocab_split``. A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernels or raises. No padding is
needed: the kernels mask the ragged row, vocab and depth edges
themselves, and read W as the (V, d) table. A ``meta`` tensor follows the
card's route and stops short of the launches (``kernels/_cost.py``); its
split is the H100's (``H100_SMS``).
"""
from __future__ import annotations

import functools
import math
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from .. import dry, on_card_route
from .._build import check, library, on_device
from .._cost import SINKS, nbytes, report
from .ref import xent_combine_ref, xent_partials_ref, xent_ref

if TYPE_CHECKING:
    from ...models.layers import ShardCtx

BM, BN = 128, 256   # the partials kernel's row tile and vocab tile
# a block's pipeline fill, in vocab tiles: its 4-stage ring of 64-deep k
# slices against a tile's 16 slices at d = 1024
FILL_TILES = 0.25
MAX_SPLIT = 64
H100_SMS = 132      # the split a meta tensor (the dry run) plans for


def vocab_split(M: int, V: int, num_sms: int) -> Tuple[int, int]:
    """(n_split, span): the vocab cut into n_split splits of ``span``
    columns (a multiple of BN; the last split may be shorter, none is
    empty). The grid is ceil(M / BM) x n_split blocks, one per SM at a
    time; of the split counts up to MAX_SPLIT, take the one whose waves x
    (tiles per split + FILL_TILES) is least, the fewest splits on a tie."""
    row_tiles, vocab_tiles = -(-M // BM), -(-V // BN)
    best = None
    for want in range(1, min(vocab_tiles, MAX_SPLIT) + 1):
        per = -(-vocab_tiles // want)
        n = -(-vocab_tiles // per)
        cost = math.ceil(row_tiles * n / num_sms) * (per + FILL_TILES)
        if best is None or cost < best[0]:
            best = (cost, n, per * BN)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _validate(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> None:
    if not on_card_route(h):
        raise ValueError(f"fused_xent: tensors on {h.device}, the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version)")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("fused_xent: h, w and labels on different devices")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"fused_xent: h and w must be bfloat16, got "
                         f"{h.dtype} and {w.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"fused_xent: labels must be int32, got "
                         f"{labels.dtype}")
    if h.ndim != 2 or w.ndim != 2 or labels.ndim != 1:
        raise ValueError("fused_xent: needs h (M, d), w (V, d), labels (M,)")
    M, d = h.shape
    if w.shape[1] != d or labels.shape[0] != M:
        raise ValueError(f"fused_xent: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if d % 8:
        raise ValueError(f"fused_xent: d={d} must be a multiple of 8")
    for name, x in (("h", h), ("w", w), ("labels", labels)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_xent: {name} must be contiguous and "
                             f"16-byte aligned")


def _validate_combine(part: torch.Tensor) -> None:
    if not on_card_route(part):
        raise ValueError(f"xent_combine: partials on {part.device}, the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version)")
    if (part.dtype != torch.float32 or part.ndim != 3 or part.shape[2] != 3
            or not part.is_contiguous()):
        raise ValueError(f"xent_combine: needs contiguous (M, n_split, 3) "
                         f"float32 partials, got {part.dtype} "
                         f"{tuple(part.shape)}")


def xent_partials(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  span: int) -> torch.Tensor:
    """h (M, d); w (V, d); labels (M,) -> (M, ceil(V / span), 3) f32
    partials over vocab splits of ``span`` columns (a multiple of BN on
    the card)."""
    if h.device.type == "cpu":
        return xent_partials_ref(h, w, labels, span)
    _validate(h, w, labels)
    if span <= 0 or span % BN:
        raise ValueError(f"xent_partials: span {span} must be a positive "
                         f"multiple of {BN}")
    M, d = h.shape
    V = w.shape[0]
    n_split = -(-V // span)
    part = torch.empty(M, n_split, 3, dtype=torch.float32, device=h.device)
    if SINKS:
        report("xent_partials", 2.0 * M * V * d, torch.bfloat16,
               nbytes(h, w, labels, part))
    if dry(h):
        return part
    lib = library()
    with on_device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_xent_partials_bf16(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(),
            M, V, d, n_split, span // BN, stream)
    check(err, "repro_xent_partials_bf16")
    xent_partials.launches += 1
    return part


def xent_combine(part: torch.Tensor) -> torch.Tensor:
    """(M, n_split, 3) f32 partials -> nll (M,) f32, splits folded in
    order."""
    if part.device.type == "cpu":
        return xent_combine_ref(part)
    _validate_combine(part)
    M, n_split, _ = part.shape
    nll = torch.empty(M, dtype=torch.float32, device=part.device)
    if SINKS:
        report("xent_combine", 0.0, torch.float32, nbytes(part, nll))
    if dry(part):
        return nll
    lib = library()
    with on_device(part.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_xent_combine(part.data_ptr(), nll.data_ptr(), M,
                                     n_split, stream)
    check(err, "repro_xent_combine")
    xent_combine.launches += 1
    return nll


def plan_span(h: torch.Tensor, V: int) -> int:
    """The split span of h (M, d) against V vocabulary columns on h's
    card (132 SMs on ``meta``)."""
    if dry(h):
        num_sms = H100_SMS
    else:
        library()  # builds (or raises) before the device is queried
        num_sms = _num_sms(h.device.index)
    return vocab_split(h.shape[0], V, num_sms)[1]


def fused_xent(h: torch.Tensor, w: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """h (M, d); w (V, d); labels (M,) in [0, V) -> nll (M,) float32."""
    if h.device.type == "cpu":
        return xent_ref(h, w, labels)
    _validate(h, w, labels)
    span = plan_span(h, w.shape[0])
    nll = xent_combine(xent_partials(h, w, labels, span))
    if not dry(h):
        fused_xent.launches += 1
    return nll


xent_partials.launches = 0
xent_combine.launches = 0
fused_xent.launches = 0


def per_sample_xent_fused(h: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, *, label_mask_value: int = -1,
                          ctx: Optional["ShardCtx"] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d); w (V, d); labels (B, S) -> (per_sample (B,), mean ()).

    With a ``ctx`` (``models.layers.ShardCtx``) whose "vocab" axis splits
    the vocabulary, w is this rank's (V / m, d) rows: ``xent_partials``
    on them with the labels shifted by the slice's offset (a label outside
    it adds nothing), the partials all-gathered over "vocab", one
    ``xent_combine`` (rank-major)."""
    B, S, d = h.shape
    mask = labels != label_mask_value
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    h2 = h.reshape(B * S, d).contiguous()
    if ctx is None or ctx.size("vocab") == 1:
        nll = fused_xent(h2, w, safe.reshape(B * S).to(torch.int32)
                         .contiguous())
    else:
        lo, n = ctx.local("vocab", w.shape[0] * ctx.size("vocab"))
        local = (safe - lo).reshape(B * S).to(torch.int32).contiguous()
        span = plan_span(h2, n) if on_card_route(h2) else n
        part = xent_partials(h2, w, local, span)
        nll = xent_combine(ctx.all_gather(part, "vocab", 1).contiguous())
    nll = nll.reshape(B, S) * mask.to(torch.float32)
    counts = torch.clamp(mask.sum(dim=-1).to(torch.float32), min=1.0)
    per_sample = nll.sum(dim=-1) / counts
    return per_sample, per_sample.mean()
