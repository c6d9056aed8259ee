"""The serving API of the dense decoder: the KV cache, prefill and one
decode step (counterpart of ``repro/models/model.py``: ``init_cache``
:45-50, ``prefill`` :148-175 and ``decode_step`` :286-333, the dense
branch).

The cache is ``{"kv": {"k", "v": (L, B, S_max, K, hd)}}``, bfloat16 by
default, updated in place layer by layer. ``prefill`` runs the prompt
through every layer (attention through the flash-attention kernel on the
card, ``attention.prefill_attn``) and returns the next token's (B, V)
float32 logits; ``decode_step`` takes one token at a device position.
Parameters stay float32 and are cast per use, as in training, so eager
decode re-casts every weight each token. Other families raise "not
ported yet" (``configs.base.require_dense``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, require_dense
from .attention import decode_attn, init_kv_cache, prefill_attn
from .layers import apply_norm, embed_tokens, mlp_fwd, unembed_matrix
from .losses import last_token_logits
from .transformer import _unstack, dtype_of

Cache = Dict[str, Dict[str, torch.Tensor]]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    require_dense(cfg)
    return {"kv": init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.resolved_head_dim(), dtype,
                                (cfg.num_layers,), device)}


def _attn_kwargs(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta)


def _layers(cfg: ModelConfig, params: Dict, cache: Cache):
    """(layer params, the layer's view of the cache) per layer."""
    kv = cache["kv"]
    for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
        yield p, {"k": kv["k"][i], "v": kv["v"][i]}


def _run(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
         cache: Cache, attn) -> torch.Tensor:
    """Every layer with ``attn(p, h, layer_cache)`` as its attention ->
    the next token's logits (B, V) f32."""
    x = embed_tokens(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    for p, c in _layers(cfg, params, cache):
        h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
        x = x + attn(p["attn"], h, c)[0]
        h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
        x = x + mlp_fwd(cfg.mlp_kind, p["mlp"], h)
    x = apply_norm(cfg.norm_kind, x, params.get("final_norm"))
    return last_token_logits(x[:, -1:], unembed_matrix(params["embed"]))


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor],
            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The prompt ``batch["tokens"]`` (B, S) through the model, filling
    ``cache[:, :S]``. -> (next-token logits (B, V) f32, cache)."""
    require_dense(cfg)
    ak = _attn_kwargs(cfg)
    logits = _run(cfg, params, batch["tokens"], cache,
                  lambda p, h, c: prefill_attn(p, h, c,
                                               chunk_q=cfg.attn_chunk_q,
                                               **ak))
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) at position ``pos`` (an int tensor of one element on
    the cache's device, or an int). -> (logits (B, V) f32, cache)."""
    require_dense(cfg)
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=tokens.device).reshape(1)
    ak = _attn_kwargs(cfg)
    logits = _run(cfg, params, tokens, cache,
                  lambda p, h, c: decode_attn(p, h, c, pos, **ak))
    return logits, cache
