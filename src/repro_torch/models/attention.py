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

On a mesh (``ShardCtx``; reference :67-69, :174) each rank runs its own
query heads ("heads") against the KV heads they read. With "kv_heads"
sharded too, the rank's K/V projections are its own heads; with them
replicated (``shard_kv_heads=False``, or fewer KV heads than shards) each
rank projects every KV head, as the reference's partitioned program does,
and passes the kernel only the ones its query heads read (``_heads``). The
output projection is row-parallel, its partial sums all-reduced. A decode
cache whose sequence is split ("cache_seq") holds S_max / m positions a
rank, and only the rank that owns ``pos`` writes the new K/V. Under the
decode rules with replicated KV heads the split is over "model": each rank
attends every query head to its positions. Under the "long" rules it is
over the data axes (one or several mesh dims, a flattened group): each rank
attends its own heads to its positions. The partial softmaxes (max, sum,
weighted values) are all-gathered over the split and folded.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import on_card_route
from ..kernels.flash_attn.ops import gqa_flash_attention
from .layers import Axes, Init, Params, ShardCtx, apply_rope, rope_angles

NEG_INF = -1e30


def init_attn(d: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool,
              lead: Tuple[int, ...], init: Init) -> Params:
    qdim, kvdim = n_heads * head_dim, n_kv * head_dim
    params = {"wq": init.normal(lead + (d, qdim)),
              "wk": init.normal(lead + (d, kvdim)),
              "wv": init.normal(lead + (d, kvdim)),
              "wo": init.normal(lead + (qdim, d))}
    if qkv_bias:
        params.update({"bq": init.full(lead + (qdim,), 0.0),
                       "bk": init.full(lead + (kvdim,), 0.0),
                       "bv": init.full(lead + (kvdim,), 0.0)})
    return params


def attn_axes(qkv_bias: bool, lead: Tuple[int, ...]) -> Axes:
    lead_ax = ("layers",) * len(lead)
    axes = {"wq": lead_ax + ("embed", "heads"),
            "wk": lead_ax + ("embed", "kv_heads"),
            "wv": lead_ax + ("embed", "kv_heads"),
            "wo": lead_ax + ("heads", "embed")}
    if qkv_bias:
        axes.update({"bq": lead_ax + ("heads",),
                     "bk": lead_ax + ("kv_heads",),
                     "bv": lead_ax + ("kv_heads",)})
    return axes


def _heads(ctx: ShardCtx, n_heads: int, n_kv: int
           ) -> Tuple[int, int, int, Optional[slice]]:
    """This rank's query heads and KV heads -> (local query heads, KV
    heads projected here, KV heads its queries read, the slice of the
    projected ones they read or None for all). The local query heads
    [h0, h0 + hl) read KV heads h // G."""
    m = ctx.size("heads")
    if m == 1:
        return n_heads, n_kv, n_kv, None
    h0, hl = ctx.local("heads", n_heads)
    if ctx.size("kv_heads") > 1:
        if ctx.dims("kv_heads") != ctx.dims("heads"):
            raise ValueError("kv_heads and heads over different mesh axes")
        kl = ctx.local("kv_heads", n_kv)[1]
        return hl, kl, kl, None
    G = n_heads // n_kv
    if (hl % G if hl >= G else G % hl):
        raise ValueError(f"{hl} query heads a rank do not tile groups of "
                         f"{G}")
    k0, k1 = h0 // G, (h0 + hl - 1) // G + 1
    return hl, n_kv, k1 - k0, slice(k0, k1)


def _project_qkv(params: Params, x: torch.Tensor, xkv: torch.Tensor,
                 n_heads: int, n_kv: int, head_dim: int,
                 ctx: ShardCtx = ShardCtx(), split_kv: bool = False):
    """Queries from x (B, Sq, d), keys and values from xkv (B, Sk, d):
    x itself for self-attention, the memory for cross-attention. On a
    mesh: this rank's query heads and the KV heads it projects
    (``_heads``), the replicated activations entering the heads'
    shards. ``split_kv`` (no gradient: decode) projects replicated KV
    heads as the reference's partitioned decode does: each rank its
    1 / m of the K/V columns, all-gathered over the heads' axis."""
    dt = x.dtype
    hl, kp, _, _ = _heads(ctx, n_heads, n_kv)
    x = ctx.enter(x, "heads")
    xkv = x if xkv is None else ctx.enter(xkv, "heads")
    wk, wv, bk, bv = (params.get(n) for n in ("wk", "wv", "bk", "bv"))
    if split_kv and ctx.size("heads") > 1 and ctx.size("kv_heads") == 1:
        c0, n = ctx.local("heads", n_kv * head_dim)
        q = x @ params["wq"].to(dt)
        k = xkv @ wk[:, c0:c0 + n].to(dt)
        v = xkv @ wv[:, c0:c0 + n].to(dt)
        if "bq" in params:
            q = q + params["bq"].to(dt)
            k = k + bk[c0:c0 + n].to(dt)
            v = v + bv[c0:c0 + n].to(dt)
        k, v = ctx.all_gather(k, "heads", -1), ctx.all_gather(v, "heads", -1)
        B, Sq, _ = x.shape
        return (q.reshape(B, Sq, hl, head_dim),
                k.reshape(B, Sq, kp, head_dim),
                v.reshape(B, Sq, kp, head_dim))
    if ctx.size("heads") > 1 and ctx.size("kv_heads") == 1:
        # every rank projects every KV head and uses its own: the
        # replicated weights' gradients are summed over the heads' shards
        wk, wv = ctx.enter(wk, "heads"), ctx.enter(wv, "heads")
        if bk is not None:
            bk, bv = ctx.enter(bk, "heads"), ctx.enter(bv, "heads")
    q = x @ params["wq"].to(dt)
    k = xkv @ wk.to(dt)
    v = xkv @ wv.to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    B, Sq, _ = x.shape
    Sk = xkv.shape[1]
    return (q.reshape(B, Sq, hl, head_dim),
            k.reshape(B, Sk, kp, head_dim),
            v.reshape(B, Sk, kp, head_dim))


def _read_heads(ctx: ShardCtx, n_heads: int, n_kv: int, k: torch.Tensor,
                v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The KV heads this rank's queries read (contiguous for the kernel)
    -> (k, v, their count)."""
    _, _, kr, sl = _heads(ctx, n_heads, n_kv)
    if sl is not None:
        k, v = k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
    return k, v, kr


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
        segment_ids: Optional[torch.Tensor] = None,
        ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
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
    q, k, v = _project_qkv(params, x, None, n_heads, n_kv, head_dim, ctx)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v, n_kv = _read_heads(ctx, n_heads, n_kv, k, v)
    n_heads = q.shape[2]
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
    return ctx.psum(out @ params["wo"].to(x.dtype), "heads")


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


def kv_cache_axes(stacked: Tuple[int, ...] = (),
                  seq_axis: Optional[str] = "cache_seq") -> Axes:
    """The logical axes of a KV cache (reference :201)."""
    ax = ("layers",) * len(stacked) + ("batch", seq_axis, "kv_heads", None)
    return {"k": ax, "v": ax}


def _write_prompt(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, ctx: ShardCtx) -> None:
    """The prompt's K/V at positions [0, S) of the cache; a rank of a
    sequence-split cache writes the positions it holds."""
    S = k.shape[1]
    n = cache["k"].shape[1]
    lo = ctx.local("cache_seq", n * ctx.size("cache_seq"))[0]
    hi = min(lo + n, S)
    if hi > lo:
        cache["k"][:, :hi - lo] = k[:, lo:hi].to(cache["k"].dtype)
        cache["v"][:, :hi - lo] = v[:, lo:hi].to(cache["v"].dtype)


def prefill_attn(params: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], *, n_heads: int, n_kv: int,
                 head_dim: int, rope_theta: float, chunk_q: int = 0,
                 ctx: ShardCtx = ShardCtx()
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal self-attention over the prompt x (B, S, d); K/V after RoPE
    are written to ``cache[:, :S]``. -> (y (B, S, d), cache)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, None, n_heads, n_kv, head_dim, ctx)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_prompt(cache, k, v, ctx)
    k, v, n_kv = _read_heads(ctx, n_heads, n_kv, k, v)
    n_heads = q.shape[2]
    if on_card_route(x):       # meta: the dry run's trace
        out = gqa_flash_attention(q, k, v, causal=True)
    else:
        out = _chunked_causal(q.reshape(B, S, n_kv, n_heads // n_kv,
                                        head_dim), k, v, positions, chunk_q)
    out = out.reshape(B, S, n_heads * head_dim)
    return ctx.psum(out @ params["wo"].to(x.dtype), "heads"), cache


def _write_token(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor, ctx: ShardCtx) -> None:
    """The new token's K/V at position ``pos``, in place; on a
    sequence-split cache only the rank that holds ``pos`` changes its
    cache (the others write back what they read)."""
    if ctx.size("cache_seq") == 1:
        # index_copy_ at a device position: no host read of pos
        cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
        return
    n = cache["k"].shape[1]
    lo = ctx.local("cache_seq", n * ctx.size("cache_seq"))[0]
    rel = pos - lo
    mine = (rel >= 0) & (rel < n)
    idx = torch.clamp(rel, 0, n - 1)
    for name, new in (("k", k), ("v", v)):
        old = cache[name].index_select(1, idx)
        cache[name].index_copy_(
            1, idx, torch.where(mine, new.to(old.dtype), old))


def _split_seq_attn(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    mask: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Every query head against this rank's cache positions, then the
    exact softmax over all positions from the ranks' partials: q (B, 1,
    K, G, hd); kc, vc (B, n, K, hd); mask (1, n) -> (B, 1, K, G, hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, kc).float()
    scores = scores / math.sqrt(hd) + mask
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), vc).float()
    part = torch.cat([o, m.permute(0, 3, 1, 2)[..., None],
                      p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]], dim=-1)
    part = ctx.all_gather(part[None], "cache_seq", 0)
    o, m, l = part[..., :hd], part[..., hd:hd + 1], part[..., hd + 1:]
    w = torch.exp(m - m.amax(dim=0))
    return ((w * o).sum(dim=0) / (w * l).sum(dim=0)).to(q.dtype)


def decode_attn(params: Params, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor, *,
                n_heads: int, n_kv: int, head_dim: int, rope_theta: float,
                ctx: ShardCtx = ShardCtx()
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (B, 1, d) at position ``pos`` (a 1-element int
    tensor on x's device). -> (y (B, 1, d), cache)."""
    B = x.shape[0]
    n = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, None, n_heads, n_kv, head_dim, ctx,
                           split_kv=True)
    cos, sin = rope_angles(pos, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_token(cache, k, v, pos, ctx)
    kc, vc = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    lo = ctx.local("cache_seq", n * ctx.size("cache_seq"))[0]
    mask = causal_mask(pos, torch.arange(lo, lo + n, device=x.device))
    hl = q.shape[2]
    split = ctx.size("cache_seq") > 1
    if split and not set(ctx.dims("cache_seq")) & set(ctx.dims("heads")):
        # positions over other mesh axes than the heads (the "long"
        # rules: the data axes): this rank's heads, its positions
        kc, vc, kr = _read_heads(ctx, n_heads, n_kv, kc, vc)
        out = _split_seq_attn(q.reshape(B, 1, kr, hl // kr, head_dim), kc,
                              vc, mask, ctx).reshape(B, 1, hl * head_dim)
    elif split:
        if ctx.size("kv_heads") > 1 or \
                ctx.dims("cache_seq") != ctx.dims("heads"):
            raise ValueError("a sequence-split cache over the heads' mesh "
                             "axis needs replicated KV heads and no other "
                             "axis")
        q = ctx.all_gather(q, "heads", 2)
        out = _split_seq_attn(q.reshape(B, 1, n_kv, n_heads // n_kv,
                                        head_dim), kc, vc, mask, ctx)
        h0 = ctx.local("heads", n_heads)[0]
        out = out.reshape(B, 1, n_heads * head_dim)[
            ..., h0 * head_dim:(h0 + hl) * head_dim]
    else:
        kc, vc, kr = _read_heads(ctx, n_heads, n_kv, kc, vc)
        qg = q.reshape(B, 1, kr, hl // kr, head_dim)
        out = _grouped_attn(qg, kc, vc, mask).reshape(B, 1, hl * head_dim)
    return ctx.psum(out @ params["wo"].to(x.dtype), "heads"), cache
