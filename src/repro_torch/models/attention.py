"""Self-attention of the dense decoder (counterpart of
``repro/models/attention.py:51-181``, ``mha`` and ``segment_causal_mask``).

Two paths compute the same function:

* the training path (``scoring=False``) in plain autograd, exactly as the
  reference's XLA path: scores formed in the compute dtype, cast to
  float32, scaled, an additive causal mask of -1e30, softmax in float32,
  probabilities cast back to the compute dtype before the PV product;
* the no-grad scoring path (``scoring=True``) through the flash-attention
  kernel (``kernels/flash_attn``), which keeps the (S, S) scores out of
  device memory.

Packed rows (``segment_ids`` with per-row (B, S) ``positions``) take the
training path with a segment-isolated causal mask; the flash kernel has
no segment support, as the reference kernel has none.

Layouts: q (B, S, H, hd) grouped as (B, S, K, G, hd) with G = H / K;
k, v (B, S, K, hd). Weights are (d_in, d_out).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attn.ops import gqa_flash_attention
from .layers import Params, apply_rope, rope_angles, winit

NEG_INF = -1e30


def init_attn(d: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool,
              lead: Tuple[int, ...], device, gen: torch.Generator) -> Params:
    qdim, kvdim = n_heads * head_dim, n_kv * head_dim
    params = {"wq": winit(lead + (d, qdim), device, gen),
              "wk": winit(lead + (d, kvdim), device, gen),
              "wv": winit(lead + (d, kvdim), device, gen),
              "wo": winit(lead + (qdim, d), device, gen)}
    if qkv_bias:
        params.update({"bq": torch.zeros(lead + (qdim,), device=device),
                       "bk": torch.zeros(lead + (kvdim,), device=device),
                       "bv": torch.zeros(lead + (kvdim,), device=device)})
    return params


def _project_qkv(params: Params, x: torch.Tensor, n_heads: int, n_kv: int,
                 head_dim: int):
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    B, S, _ = x.shape
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Additive causal mask from positions: (Sq,), (Sk,) -> (Sq, Sk) f32."""
    ok = q_pos[:, None] >= k_pos[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def segment_causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        q_seg: torch.Tensor, k_seg: torch.Tensor
                        ) -> torch.Tensor:
    """Segment-isolated causal mask for packed rows: (B, Sq) positions and
    segment ids of the queries, (B, Sk) of the keys -> (B, Sq, Sk) f32
    additive. A query sees a key iff both lie in the same non-padding
    segment and the key is causally prior within it; padding queries see
    nothing (their softmax is uniform and their labels are masked)."""
    ok = ((q_pos[:, :, None] >= k_pos[:, None, :])
          & (q_seg[:, :, None] == k_seg[:, None, :])
          & (q_seg[:, :, None] > 0))
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _grouped_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, K, G, hd); k, v (B, S, K, hd); additive mask (Sq, Sk) or
    (B, Sq, Sk)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores + (mask if mask.ndim == 2 else mask[:, None, None])
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def mha(params: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
        head_dim: int, rope_theta: float, causal: bool = True,
        scoring: bool = False, positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal self-attention over x (B, S, d) -> (B, S, d).

    ``segment_ids`` (B, S) switches on packed-row masking (causal within
    each segment, nothing across segments or padding); ``positions`` must
    then be the per-row (B, S) local positions, so RoPE restarts per
    document."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if segment_ids is not None:
        if positions.ndim != 2:
            raise ValueError("mha: segment_ids needs per-row (B, S) "
                             "positions")
        if scoring:
            raise NotImplementedError("mha: the flash-attention kernel has "
                                      "no segment masking; packed rows take "
                                      "the training path")
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if scoring:
        out = gqa_flash_attention(q, k, v, causal=causal)
    else:
        G = n_heads // n_kv
        qg = q.reshape(B, S, n_kv, G, head_dim)
        if segment_ids is not None:
            m = segment_causal_mask(positions, positions, segment_ids,
                                    segment_ids)
        else:
            m = causal_mask(positions, positions) if causal else None
        out = _grouped_attn(qg, k, v, m)
    out = out.reshape(B, S, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype)
