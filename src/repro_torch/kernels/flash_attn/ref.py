"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attn.cu``).

It mirrors ``repro/kernels/flash_attn/flash_attn.py:flash_attention``
behind its GQA wrapper ``ops.gqa_flash_attention``: scores and
probabilities in float32 (including the PV product), scale 1/sqrt(hd),
causal mask -1e30, output in the input dtype. Query head h reads kv head
h // G through the (K, G) grouping, with no repeated K or V. Used by the
CPU path and by the on-card comparison.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, K, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / hd ** 0.5)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
