"""Layer primitives: norms, RoPE, MLPs, embeddings (counterpart of
``repro/models/layers.py:74-228``).

Functions on tensors. Parameters are plain dicts mirroring the JAX pytree;
weights keep the JAX ``(d_in, d_out)`` layout of ``x @ W``. Norms compute in
float32 and cast back, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def nonparam_ln(x: torch.Tensor) -> torch.Tensor:
    """OLMo's LayerNorm without affine parameters."""
    return layernorm(x, None, None)


def apply_norm(kind: str, x: torch.Tensor,
               params: Optional[Params]) -> torch.Tensor:
    """kind: rmsnorm | layernorm | nonparam_ln."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layernorm(x, params["scale"] if params else None,
                         params.get("bias") if params else None)
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(f"unknown norm kind {kind!r}")


def init_norm(kind: str, d: int, lead: Tuple[int, ...],
              device) -> Optional[Params]:
    if kind == "rmsnorm":
        return {"scale": torch.ones(lead + (d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(lead + (d,), device=device),
                "bias": torch.zeros(lead + (d,), device=device)}
    if kind == "nonparam_ln":
        return None
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE (split-half convention)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos, sin of shape (..., S, head_dim // 2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python-number base: no host-to-device copy (a host sync) a call
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos, sin (S, D/2) or (B, S, D/2). The first half of
    the head dims rotates with the second half (not interleaved pairs)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(kind: str, d: int, f: int, lead: Tuple[int, ...], device,
             gen: torch.Generator) -> Params:
    if kind == "swiglu":
        return {"w_gate": winit(lead + (d, f), device, gen),
                "w_up": winit(lead + (d, f), device, gen),
                "w_down": winit(lead + (f, d), device, gen)}
    if kind == "gelu":
        return {"w_up": winit(lead + (d, f), device, gen),
                "b_up": torch.zeros(lead + (f,), device=device),
                "w_down": winit(lead + (f, d), device, gen),
                "b_down": torch.zeros(lead + (d,), device=device)}
    raise ValueError(kind)


def mlp_fwd(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), in x's dtype."""
    dt = x.dtype
    if kind == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        return (F.silu(g) * u) @ params["w_down"].to(dt)
    if kind == "gelu":
        h = x @ params["w_up"].to(dt) + params["b_up"].to(dt)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
        return h @ params["w_down"].to(dt) + params["b_down"].to(dt)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Init, embedding / unembedding
# ---------------------------------------------------------------------------

def winit(shape: Tuple[int, ...], device, gen: torch.Generator,
          scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) float32 weights from the caller's generator."""
    return scale * torch.randn(shape, device=device, generator=gen)


def init_embedding(vocab: int, d: int, tie: bool, device,
                   gen: torch.Generator) -> Params:
    params = {"tok": winit((vocab, d), device, gen)}
    if not tie:
        params["head"] = winit((d, vocab), device, gen)
    return params


def embed_tokens(params: Params, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return params["tok"].to(compute_dtype)[tokens.long()]


def unembed_matrix(params: Params) -> torch.Tensor:
    """The (d, vocab) output projection (a view of ``tok`` when tied)."""
    if "head" in params:
        return params["head"]
    return params["tok"].t()


def unembed_table(params: Params) -> torch.Tensor:
    """The (vocab, d) output table the xent kernel reads: ``tok`` itself
    when tied (no copy), else the transposed untied head."""
    if "head" in params:
        return params["head"].t()
    return params["tok"]
