"""The serving API of the ported families: the caches, prefill and one
decode step (counterpart of ``repro/models/model.py``: ``init_cache``
:45-87, ``prefill`` :148-278, ``_ffn`` :281-293 and ``decode_step``
:296-434, the dense, moe, ssm and hybrid branches).

Caches, leading dims stacked as the reference's:

    dense / moe: {"kv": {"k", "v": (L, B, S_max, K, hd)}}
    ssm:         {"ssm": {"ssm_state": (L, B, nh, P, N),
                          "conv_x": (L, B, W-1, d_inner),
                          "conv_bc": (L, B, W-1, 2N)}}
    hybrid:      {"ssm": the same led by (n_sites, every),
                  "attn_kv": {"k", "v": (n_sites, B, S_max, K, hd)}}

KV caches are bfloat16 by default, SSM caches float32 (the conv tails are
the PRE-conv inputs, which continue the depthwise window). Caches are
updated in place, layer by layer. ``prefill`` runs the prompt through
every layer (every causal attention through the flash-attention kernel on
the card, ``attention.prefill_attn``) and returns the next token's (B, V)
float32 logits; ``decode_step`` takes one token at a device position.
Parameters stay float32 and are cast per use, as in training, so eager
decode re-casts every weight each token. A MoE decode step routes its B
tokens with the capacity of B tokens, as the reference's does. vlm and
encdec raise "not ported yet" (``configs.base.require_ported``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, require_ported
from .attention import decode_attn, init_kv_cache, prefill_attn
from .layers import apply_norm, embed_tokens, unembed_matrix
from .losses import last_token_logits
from .ssm import init_ssm_cache, mamba2_decode, mamba2_fwd
from .transformer import _unstack, dtype_of, ffn, n_sites, shared_cfg

Cache = Dict[str, Dict[str, torch.Tensor]]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    require_ported(cfg)
    hd = cfg.resolved_head_dim()
    if cfg.family in ("dense", "moe"):
        return {"kv": init_kv_cache(batch, max_len, cfg.num_kv_heads, hd,
                                    dtype, (cfg.num_layers,), device)}
    lead = (cfg.num_layers,) if cfg.family == "ssm" else n_sites(cfg)
    cache = {"ssm": init_ssm_cache(
        batch, cfg.d_model, state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        stacked=lead, device=device)}
    if cfg.family == "hybrid":
        cache["attn_kv"] = init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                         hd, dtype, lead[:1], device)
    return cache


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


def _run(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
         cache: Cache, attn, mamba) -> torch.Tensor:
    """Every layer with ``attn(p, h, layer's kv cache) -> (y, cache)`` as
    its attention and ``mamba(p, h, layer's ssm cache) -> (y, new
    cache)`` as its Mamba2 block -> the next token's logits (B, V) f32."""
    x = embed_tokens(params["embed"], tokens, dtype_of(cfg.compute_dtype))

    def dense_block(bcfg, p, x, kv):
        h = apply_norm(bcfg.norm_kind, x, p.get("ln1"))
        x = x + attn(p["attn"], h, kv)[0]
        h = apply_norm(bcfg.norm_kind, x, p.get("ln2"))
        return x + ffn(bcfg, p, h)

    def mamba_block(p, x, sc):
        h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
        y, new = mamba(p["mamba"], h, sc)
        _write(sc, new)
        return x + y

    if cfg.family in ("dense", "moe"):
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = dense_block(cfg, p, x, _view(cache["kv"], i))
    elif cfg.family == "ssm":
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = mamba_block(p, x, _view(cache["ssm"], i))
    else:  # hybrid
        ns, k = n_sites(cfg)
        scfg = shared_cfg(cfg)
        for s, site in enumerate(_unstack(params["layers"], ns)):
            for j, p in enumerate(_unstack(site, k)):
                x = mamba_block(p, x, _view(cache["ssm"], s, j))
            x = dense_block(scfg, params["shared"], x,
                            _view(cache["attn_kv"], s))
    x = apply_norm(cfg.norm_kind, x, params.get("final_norm"))
    return last_token_logits(x[:, -1:], unembed_matrix(params["embed"]))


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor],
            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The prompt ``batch["tokens"]`` (B, S) through the model, filling
    the KV caches' ``[:, :S]`` and the SSM states. -> (next-token logits
    (B, V) f32, cache)."""
    require_ported(cfg)
    ak, sk = _attn_kwargs(cfg), _ssm_kwargs(cfg)
    logits = _run(
        cfg, params, batch["tokens"], cache,
        lambda p, h, c: prefill_attn(p, h, c, chunk_q=cfg.attn_chunk_q,
                                     **ak),
        lambda p, h, c: mamba2_fwd(p, h, chunk=cfg.ssm_chunk,
                                   return_state=True, **sk))
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) at position ``pos`` (an int tensor of one element on
    the cache's device, or an int). -> (logits (B, V) f32, cache)."""
    require_ported(cfg)
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=tokens.device).reshape(1)
    ak, sk = _attn_kwargs(cfg), _ssm_kwargs(cfg)
    logits = _run(cfg, params, tokens, cache,
                  lambda p, h, c: decode_attn(p, h, c, pos, **ak),
                  lambda p, h, c: mamba2_decode(p, h, c, **sk))
    return logits, cache
