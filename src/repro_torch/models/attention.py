"""Self- and cross-attention (counterpart of
``repro/models/attention.py:51-188``, ``mha``, ``segment_causal_mask`` and
``cross_attn``, and :195-267, the KV-cache paths of serving).

Two paths compute the same function:

* the training path (``scoring=False``) in plain autograd, exactly as the
  reference's XLA path: scores formed in the compute dtype, cast to
  float32, scaled, an additive causal mask of -1e30, softmax in float32,
  probabilities cast back to the compute dtype before the PV product.
  When ``chunk_q`` (``ModelConfig.attn_chunk_q``) divides S and is smaller,
  it runs over query chunks of ``chunk_q`` rows, each against all keys
  with its own rows' mask (reference :141-167): the same values, with one
  chunk's float32 scores formed at a time;
* the no-grad scoring path (``scoring=True``) through the flash-attention
  kernel (``kernels/flash_attn``), which keeps the (S, S) scores out of
  device memory; causal, or not (``causal=False``: the encoder).

``cross_attn`` (queries from x, keys and values from a memory of another
length: image embeddings, or the encoder's output) is plain PyTorch on
both paths, as the reference's is XLA.

Packed rows (``segment_ids`` with per-row (B, S) ``positions``) take the
training path with a segment-isolated causal mask; the flash kernel has
no segment support, as the reference kernel has none.

Serving: ``prefill_attn`` writes the prompt's K/V (after RoPE) to the
cache and attends causally over the prompt. On a CUDA tensor it takes the
flash-attention kernel (causal, no segments; bf16 only, as the scoring
forward), where the reference runs XLA's query-chunked attention: the
same function, so ``chunk_q`` is ignored there; on a CPU tensor the plain
chunked path. ``decode_attn`` attends one query against the cache, every
position above ``pos`` masked, in plain PyTorch as the reference's XLA.
The cache is updated in place.

Layouts: q (B, S, H, hd) grouped as (B, S, K, G, hd) with G = H / K;
k, v (B, S, K, hd). Weights are (d_in, d_out).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import on_card_route
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


def _project_qkv(params: Params, x: torch.Tensor, xkv: torch.Tensor,
                 n_heads: int, n_kv: int, head_dim: int):
    """Queries from x (B, Sq, d), keys and values from xkv (B, Sk, d):
    x itself for self-attention, the memory for cross-attention."""
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = xkv @ params["wk"].to(dt)
    v = xkv @ params["wv"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    B, Sq, _ = x.shape
    Sk = xkv.shape[1]
    return (q.reshape(B, Sq, n_heads, head_dim),
            k.reshape(B, Sk, n_kv, head_dim),
            v.reshape(B, Sk, n_kv, head_dim))


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


def _mask(positions: torch.Tensor, segment_ids: Optional[torch.Tensor],
          causal: bool, rows: slice) -> Optional[torch.Tensor]:
    """The additive mask of the query ``rows`` against every key."""
    if segment_ids is not None:
        return segment_causal_mask(positions[:, rows], positions,
                                   segment_ids[:, rows], segment_ids)
    return causal_mask(positions[rows], positions) if causal else None


def mha(params: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
        head_dim: int, rope_theta: float, chunk_q: int = 0,
        causal: bool = True, scoring: bool = False,
        positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over x (B, S, d) -> (B, S, d), causal unless
    ``causal=False`` (the encoder's).

    ``segment_ids`` (B, S) switches on packed-row masking (causal within
    each segment, nothing across segments or padding); ``positions`` must
    then be the per-row (B, S) local positions, so RoPE restarts per
    document. ``chunk_q`` chunks the training path's queries (see the
    module docstring); the scoring path ignores it."""
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
    q, k, v = _project_qkv(params, x, x, n_heads, n_kv, head_dim)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if scoring:
        out = gqa_flash_attention(q, k, v, causal=causal)
    else:
        G = n_heads // n_kv
        qg = q.reshape(B, S, n_kv, G, head_dim)
        if chunk_q and S > chunk_q and S % chunk_q == 0:
            out = torch.cat([
                _grouped_attn(qg[:, lo:lo + chunk_q], k, v,
                              _mask(positions, segment_ids, causal,
                                    slice(lo, lo + chunk_q)))
                for lo in range(0, S, chunk_q)], dim=1)
        else:
            out = _grouped_attn(qg, k, v, _mask(positions, segment_ids,
                                                causal, slice(None)))
    out = out.reshape(B, S, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype)


def cross_attn(params: Params, x: torch.Tensor, memory: torch.Tensor, *,
               n_heads: int, n_kv: int, head_dim: int) -> torch.Tensor:
    """Cross-attention: queries from x (B, Sq, d), keys and values from
    ``memory`` (B, Sk, d), GQA, no RoPE and no mask -> (B, Sq, d). Plain
    PyTorch on every device, as the reference's is XLA (its flash kernel
    takes one sequence length for q and kv)."""
    B, Sq, _ = x.shape
    q, k, v = _project_qkv(params, x, memory, n_heads, n_kv, head_dim)
    qg = q.reshape(B, Sq, n_kv, n_heads // n_kv, head_dim)
    out = _grouped_attn(qg, k, v, None).reshape(B, Sq, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# KV-cache paths (prefill / decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, stacked: Tuple[int, ...] = (),
                  device="cuda") -> Dict[str, torch.Tensor]:
    shape = tuple(stacked) + (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _chunked_causal(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, chunk_q: int) -> torch.Tensor:
    """Plain causal attention over query chunks of ``chunk_q`` (all at
    once when it does not divide S)."""
    S = qg.shape[1]
    if chunk_q and S > chunk_q and S % chunk_q == 0:
        return torch.cat([
            _grouped_attn(qg[:, lo:lo + chunk_q], k, v,
                          causal_mask(positions[lo:lo + chunk_q], positions))
            for lo in range(0, S, chunk_q)], dim=1)
    return _grouped_attn(qg, k, v, causal_mask(positions, positions))


def prefill_attn(params: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], *, n_heads: int, n_kv: int,
                 head_dim: int, rope_theta: float, chunk_q: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal self-attention over the prompt x (B, S, d); K/V after RoPE
    are written to ``cache[:, :S]``. -> (y (B, S, d), cache)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, x, n_heads, n_kv, head_dim)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    if on_card_route(x):       # meta: the dry run's trace
        out = gqa_flash_attention(q, k, v, causal=True)
    else:
        out = _chunked_causal(q.reshape(B, S, n_kv, n_heads // n_kv,
                                        head_dim), k, v, positions, chunk_q)
    out = out.reshape(B, S, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype), cache


def decode_attn(params: Params, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor, *,
                n_heads: int, n_kv: int, head_dim: int, rope_theta: float
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (B, 1, d) at position ``pos`` (a 1-element int
    tensor on x's device). -> (y (B, 1, d), cache)."""
    B = x.shape[0]
    S_max = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, x, n_heads, n_kv, head_dim)
    cos, sin = rope_angles(pos, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # index_copy_ at a device position: no host read of pos
    cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
    kc, vc = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    qg = q.reshape(B, 1, n_kv, n_heads // n_kv, head_dim)
    mask = causal_mask(pos, torch.arange(S_max, device=x.device))
    out = _grouped_attn(qg, kc, vc, mask).reshape(B, 1, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype), cache
