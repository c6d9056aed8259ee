"""The serving API of all six families: the stub lengths, the caches,
prefill and one decode step (counterpart of ``repro/models/model.py``:
``encoder_len``/``image_tokens`` :32-38, ``init_cache`` :45-87,
``_project_cross_kv``/``_cross_attn_cached`` :117-145, ``prefill``
:148-278, ``_ffn`` :281-293 and ``decode_step`` :296-434).

Caches, leading dims stacked as the reference's:

    dense / moe: {"kv": {"k", "v": (L, B, S_max, K, hd)}}
    ssm:         {"ssm": {"ssm_state": (L, B, nh, P, N),
                          "conv_x": (L, B, W-1, d_inner),
                          "conv_bc": (L, B, W-1, 2N)}}
    hybrid:      {"ssm": the same led by (n_sites, every),
                  "attn_kv": {"k", "v": (n_sites, B, S_max, K, hd)}}
    vlm:         {"kv": (n_sites, every, B, S_max, K, hd),
                  "cross_kv": {"k", "v": (n_sites, B, n_img, K, hd)}}
    encdec:      {"kv": (L, B, S_max, K, hd),
                  "cross_kv": {"k", "v": (L, B, T_enc, K, hd)}}

KV caches are bfloat16 by default, SSM caches float32 (the conv tails are
the PRE-conv inputs, which continue the depthwise window). Caches are
updated in place, layer by layer. ``prefill`` runs the prompt through
every layer (every causal attention through the flash-attention kernel on
the card, ``attention.prefill_attn``) and returns the next token's (B, V)
float32 logits; ``decode_step`` takes one token at a device position.
Parameters stay float32 and are cast per use, as in training, so eager
decode re-casts every weight each token. A MoE decode step routes its B
tokens with the capacity of B tokens, as the reference's does.

vlm and encdec: the prefill reads its memory from the batch
(``image_embeds``, or ``frames`` through the encoder, a no-grad pass
whose self-attention takes the flash kernel without the causal mask on
the card), projects each cross-attention's K/V from it once, attends with
them, and stores them in bfloat16 as the cache's new ``cross_kv``, sized
by this prompt's memory (the reference's prefill returns its own); each
decode step attends to the stored K/V.

On a mesh (``ctx``, the dense, MoE, SSM and hybrid families; reference
:87, :158, :319) the cache is this rank's shard of each leaf of the
reference's (``cache_axes``): its batch rows; its KV heads, or with
replicated KV heads under the decode rules every head over S_max / m
positions (``attention.decode_attn``); an SSM state's heads and a conv
tail's inner channels over "mlp" (the B/C tail whole); at ``long_500k``
(the "long" rules) every row, and the KV cache's positions over the
data axes. The logits are gathered over the vocabulary. A MoE decode
step's few tokens usually make one dispatch group spanning the data
ranks (``moe._auto_groups`` on the global count).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import on_card_route
from .attention import (_grouped_attn, decode_attn, init_kv_cache,
                        kv_cache_axes, prefill_attn)
from .layers import ShardCtx, apply_norm, embed_tokens, local_shape, \
    unembed_matrix
from .losses import last_token_logits
from .ssm import init_ssm_cache, mamba2_decode, mamba2_fwd, ssm_cache_axes
from .transformer import (_unstack, block_axes, check_mesh, decoder_layer,
                          dtype_of, encode, ffn, final_norm,
                          gated_cross_block, memory_of, n_sites, shared_cfg)

Cache = Dict[str, Dict[str, torch.Tensor]]


def encoder_len(cfg: ModelConfig, seq_len: int) -> int:
    """The audio frontend stub's frame count for a sequence of
    ``seq_len``."""
    return min(max(seq_len // 4, 64), 4096)


def image_tokens(cfg: ModelConfig) -> int:
    """The vision frontend stub's patch embeddings an image."""
    return cfg.num_image_tokens or 1600


def cache_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``init_cache``'s tree (reference :87)."""
    if cfg.family in ("dense", "moe"):
        return {"kv": kv_cache_axes((cfg.num_layers,))}
    if cfg.family == "ssm":
        return {"ssm": ssm_cache_axes((cfg.num_layers,))}
    if cfg.family == "hybrid":
        ns, k = n_sites(cfg)
        return {"ssm": ssm_cache_axes((ns, k)),
                "attn_kv": kv_cache_axes((ns,))}
    if cfg.family == "vlm":
        ns, k = n_sites(cfg)
        return {"kv": kv_cache_axes((ns, k)),
                "cross_kv": kv_cache_axes((ns,), seq_axis=None)}
    if cfg.family == "encdec":
        L = (cfg.num_layers,)
        return {"kv": kv_cache_axes(L),
                "cross_kv": kv_cache_axes(L, seq_axis=None)}
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               ctx: ShardCtx = ShardCtx()) -> Cache:
    """Zero caches for ``batch`` prompts of up to ``max_len`` tokens; on
    a mesh this rank's shard of each (``cache_axes``)."""
    if ctx.mesh is not None:
        check_mesh(cfg, ctx)
        full = init_cache(cfg, batch, max_len, dtype, "meta")
        return _local_zeros(full, cache_axes(cfg), ctx, device)
    hd = cfg.resolved_head_dim()
    if cfg.family in ("dense", "moe", "encdec"):
        cache = {"kv": init_kv_cache(batch, max_len, cfg.num_kv_heads, hd,
                                     dtype, (cfg.num_layers,), device)}
        if cfg.family == "encdec":
            cache["cross_kv"] = init_kv_cache(
                batch, encoder_len(cfg, max_len), cfg.num_kv_heads, hd,
                dtype, (cfg.num_layers,), device)
        return cache
    if cfg.family == "vlm":
        ns, k = n_sites(cfg)
        return {"kv": init_kv_cache(batch, max_len, cfg.num_kv_heads, hd,
                                    dtype, (ns, k), device),
                "cross_kv": init_kv_cache(batch, image_tokens(cfg),
                                          cfg.num_kv_heads, hd, dtype,
                                          (ns,), device)}
    lead = (cfg.num_layers,) if cfg.family == "ssm" else n_sites(cfg)
    cache = {"ssm": init_ssm_cache(
        batch, cfg.d_model, state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        stacked=lead, device=device)}
    if cfg.family == "hybrid":
        cache["attn_kv"] = init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                         hd, dtype, lead[:1], device)
    return cache


def _local_zeros(full, axes, ctx: ShardCtx, device):
    """Zeros of this rank's shape of each leaf of ``full`` (global shapes,
    any device) with logical ``axes``."""
    if isinstance(full, dict):
        return {k: _local_zeros(v, axes[k], ctx, device)
                for k, v in full.items()}
    return torch.zeros(local_shape(full.shape, axes, ctx), dtype=full.dtype,
                       device=device)


def _attn_kwargs(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta)


def _ssm_kwargs(cfg: ModelConfig) -> Dict:
    return dict(state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand)


def _view(tree: Dict[str, torch.Tensor], *idx) -> Dict[str, torch.Tensor]:
    """The slice ``idx`` of each stacked cache leaf (a view: writes land
    in the cache)."""
    return {k: v[idx] for k, v in tree.items()}


def _write(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    for k, v in src.items():
        dst[k].copy_(v)


def _project_cross_kv(cfg: ModelConfig, p: Dict, memory: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """A cross-attention's K/V from the memory (B, T, d), in its dtype."""
    hd = cfg.resolved_head_dim()
    B, T, _ = memory.shape
    k = memory @ p["wk"].to(memory.dtype)
    v = memory @ p["wv"].to(memory.dtype)
    if "bk" in p:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
    return {"k": k.reshape(B, T, cfg.num_kv_heads, hd),
            "v": v.reshape(B, T, cfg.num_kv_heads, hd)}


def _cross_attn_cached(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       ckv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-attention of x (B, S, d) to projected K/V (no mask)."""
    hd = cfg.resolved_head_dim()
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                  hd)
    out = _grouped_attn(q, ckv["k"].to(x.dtype), ckv["v"].to(x.dtype), None)
    return out.reshape(B, S, cfg.num_heads * hd) @ p["wo"].to(x.dtype)


def _run(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
         cache: Cache, attn, mamba, cross=None,
         ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """Every layer with ``attn(p, h, layer's kv cache) -> (y, cache)`` as
    its attention, ``mamba(p, h, layer's ssm cache) -> (y, new cache)`` as
    its Mamba2 block and ``cross(p, h, i) -> y`` as the cross-attention
    of site or layer ``i`` (vlm, encdec) -> the next token's logits (B, V)
    f32."""
    check_mesh(cfg, ctx)
    x = embed_tokens(params["embed"], tokens, dtype_of(cfg.compute_dtype),
                     ctx)
    lax, sax = block_axes(cfg, ctx)

    def dense_block(bcfg, p, x, kv, axes):
        p = ctx.gather_params(p, axes)
        h = apply_norm(bcfg.norm_kind, x, p.get("ln1"))
        x = x + attn(p["attn"], h, kv)[0]
        h = apply_norm(bcfg.norm_kind, x, p.get("ln2"))
        return x + ffn(bcfg, p, h, ctx)

    def mamba_block(p, x, sc):
        p = ctx.gather_params(p, lax)
        h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
        y, new = mamba(p["mamba"], h, sc)
        _write(sc, new)
        return x + y

    if cfg.family in ("dense", "moe"):
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = dense_block(cfg, p, x, _view(cache["kv"], i), lax)
    elif cfg.family == "ssm":
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = mamba_block(p, x, _view(cache["ssm"], i))
    elif cfg.family == "hybrid":
        ns, k = n_sites(cfg)
        scfg = shared_cfg(cfg)
        for s, site in enumerate(_unstack(params["layers"], ns)):
            for j, p in enumerate(_unstack(site, k)):
                x = mamba_block(p, x, _view(cache["ssm"], s, j))
            x = dense_block(scfg, params["shared"], x,
                            _view(cache["attn_kv"], s), sax)
    elif cfg.family == "vlm":
        ns, k = n_sites(cfg)
        for s, (site, cp) in enumerate(zip(_unstack(params["layers"], ns),
                                           _unstack(params["cross"], ns))):
            for j, p in enumerate(_unstack(site, k)):
                x = dense_block(cfg, p, x, _view(cache["kv"], s, j), lax)
            x = gated_cross_block(cfg, cp, x,
                                  lambda pa, h, s=s: cross(pa, h, s))
    elif cfg.family == "encdec":
        L = cfg.num_layers
        for i, (p, cp) in enumerate(zip(_unstack(params["layers"], L),
                                        _unstack(params["cross"], L))):
            kv = _view(cache["kv"], i)
            x = decoder_layer(cfg, p, cp, x,
                              lambda pa, h, kv=kv: attn(pa, h, kv)[0],
                              lambda pa, h, i=i: cross(pa, h, i))
    else:
        raise ValueError(cfg.family)
    x = final_norm(cfg, params, x, ctx)
    return last_token_logits(x[:, -1:], unembed_matrix(params["embed"], ctx),
                             ctx)


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor],
            cache: Cache, ctx: ShardCtx = ShardCtx()
            ) -> Tuple[torch.Tensor, Cache]:
    """The prompt ``batch["tokens"]`` (B, S) through the model, filling
    the KV caches' ``[:, :S]`` and the SSM states; vlm and encdec read
    ``image_embeds`` / ``frames`` and replace ``cross_kv`` (bfloat16). ->
    (next-token logits (B, V) f32, cache)."""
    ak, sk = _attn_kwargs(cfg), _ssm_kwargs(cfg)
    cross = None
    if cfg.family in ("vlm", "encdec"):
        memory = memory_of(cfg, batch)
        if cfg.is_encdec:     # a no-grad pass: the flash kernel on the card
            memory = encode(cfg, params, memory,
                            scoring=on_card_route(memory))
        else:
            memory = memory.to(dtype_of(cfg.compute_dtype))
        # one K/V a site (vlm) or a decoder layer (encdec)
        n = n_sites(cfg)[0] if cfg.family == "vlm" else cfg.num_layers
        B, T = memory.shape[:2]
        new = init_kv_cache(B, T, cfg.num_kv_heads, cfg.resolved_head_dim(),
                            torch.bfloat16, (n,), memory.device)

        def cross(p, h, i):
            ckv = _project_cross_kv(cfg, p, memory)
            for name in ("k", "v"):
                new[name][i] = ckv[name]
            return _cross_attn_cached(cfg, p, h, ckv)
        cache["cross_kv"] = new
    logits = _run(
        cfg, params, batch["tokens"], cache,
        lambda p, h, c: prefill_attn(p, h, c, chunk_q=cfg.attn_chunk_q,
                                     ctx=ctx, **ak),
        lambda p, h, c: mamba2_fwd(p, h, chunk=cfg.ssm_chunk,
                                   return_state=True, ctx=ctx, **sk),
        cross, ctx)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor, ctx: ShardCtx = ShardCtx()
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) at position ``pos`` (an int tensor of one element on
    the cache's device, or an int). -> (logits (B, V) f32, cache)."""
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=tokens.device).reshape(1)
    ak, sk = _attn_kwargs(cfg), _ssm_kwargs(cfg)
    logits = _run(cfg, params, tokens, cache,
                  lambda p, h, c: decode_attn(p, h, c, pos, ctx=ctx, **ak),
                  lambda p, h, c: mamba2_decode(p, h, c, ctx=ctx, **sk),
                  lambda p, h, i: _cross_attn_cached(
                      cfg, p, h, _view(cache["cross_kv"], i)), ctx)
    return logits, cache
