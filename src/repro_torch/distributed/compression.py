"""Int8 compression with error feedback, the local leg (counterpart of
``repro/distributed/compression.py:36-78, 138-168``).

``compress_decompress`` is what the engine's ``--grad-compression`` path
runs on one device: the residual-corrected gradient ``g + err`` goes
through a per-block symmetric int8 quantize -> dequantize (scale =
max|block| / 127, floored at ``SCALE_FLOOR``, so an all-zero block round-
trips to exactly 0), and the quantization residual is carried to the next
step. The per-block grid is the one the reference's compressed all-reduce
puts on the wire, so the modelled lossy leg and the wire agree.

``torch.round`` rounds half to even as ``jnp.round`` does and the divide
is IEEE in both, so on the same float32 input every function here is
bitwise the reference's. The cross-device legs (``_compressed_reduce_1d``,
``compressed_psum_sum``) belong to the multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

QMAX = 127.0
SCALE_FLOOR = 1e-12


def _over_qmax(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by IEEE division: a device tensor as the divisor, since
    PyTorch on CUDA multiplies by the reciprocal of a Python number (or of
    a CPU scalar), one ulp off the reference's divide."""
    return x / torch.full((), QMAX, device=x.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    scale = torch.clamp(_over_qmax(x.abs().max()), min=SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_int8_blocks(x: torch.Tensor, block: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a 1-D vector -> (q (n,)
    int8, scales (ceil(n / block),) f32). The last block may be short
    (zero-padded for its max); an all-zero block gets ``SCALE_FLOOR``."""
    n = x.shape[0]
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, nb * block - n)).reshape(nb, block)
    scales = torch.clamp(_over_qmax(xp.abs().amax(dim=1)), min=SCALE_FLOOR)
    q = torch.clamp(torch.round(xp / scales[:, None]), -QMAX, QMAX)
    return q.reshape(-1)[:n].to(torch.int8), scales


def dequantize_int8_blocks(q: torch.Tensor, scales: torch.Tensor,
                           block: int) -> torch.Tensor:
    n = q.shape[0]
    nb = scales.shape[0]
    qp = torch.nn.functional.pad(q, (0, nb * block - n)).reshape(
        nb, block).to(torch.float32)
    return (qp * scales[:, None]).reshape(-1)[:n]


class ErrorFeedbackState:
    """Carried quantization residual per gradient tensor (a dict of f32
    zeros shaped like the parameters)."""

    @staticmethod
    def init(params) -> Dict:
        if isinstance(params, dict):
            return {k: ErrorFeedbackState.init(v) for k, v in params.items()}
        return torch.zeros_like(params, dtype=torch.float32)


def compress_decompress(g: torch.Tensor, err: torch.Tensor, block: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local quantize -> dequantize of ``g + err`` on the per-``block``
    grid -> (dequantized gradient (g's shape, f32), new residual)."""
    corrected = g.to(torch.float32) + err
    q, scales = quantize_int8_blocks(corrected.reshape(-1), block)
    deq = dequantize_int8_blocks(q, scales, block).reshape(g.shape)
    return deq, corrected - deq


def wire_bytes_per_element(axis_size: int, block: int = 256
                           ) -> Tuple[float, float]:
    """(compressed, f32-ring) bytes per element on the wire for a DP
    reduce: int8 all_to_all + int8 all_gather with their per-block f32
    scales, against the ring's 2 (D - 1) / D float32 passes."""
    compressed = (1.0 + 4.0 / block) * 2.0
    ring = 2.0 * 4.0 * (axis_size - 1) / axis_size
    return compressed, ring
