"""Batch-level selection: pick a mini-batch of b from a meta-batch of B
(counterpart of ``repro/core/selection.py:34-121``).

  es / loss : Gumbel top-k, sampling without replacement with p_i ~ w_i
  order     : deterministic top-k on the weights (Ordered SGD)
  uniform   : uniform without replacement

``masked_select_kept`` is the packed-batch form: it keeps at most k of the
valid document slots and returns a kept mask.

The Gumbel noise comes from the caller's ``torch.Generator``, or is
injected as a tensor (``gumbel=``) so that a test can hand the port the
very noise JAX's step drew. The Gumbel top-k orders as ``jax.lax.top_k``
does (``top_k``: a stable sort, ties to the lower index), which is what
lets a sharded store's candidate merge give the replicated selection bit
for bit; the other top-k's are ``torch.topk``, whose order among ties is
unspecified, so compare their index SETS.
"""
from __future__ import annotations

from typing import Optional, TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from .scores import Store

_EPS = 1e-20


def sample_gumbel(shape, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise, float32, from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def top_k(keys: torch.Tensor, k: int, dim: int = -1):
    """-> (values, indices) of the k largest ``keys`` along ``dim`` in
    ``jax.lax.top_k``'s order: descending, equal keys by increasing
    index."""
    values, indices = torch.sort(keys, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def gumbel_topk_select(weights: torch.Tensor, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k of len(weights) without replacement, p_i ~ max(w_i, eps) -> (k,)
    int32 indices (argtop-k of log w + G)."""
    logw = torch.log(torch.clamp(weights.float(), min=_EPS))
    if gumbel is None:
        gumbel = sample_gumbel(weights.shape, generator, weights.device)
    return top_k(logw + gumbel.to(logw.device), k)[1].to(torch.int32)


def topk_select(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Deterministic top-k (Ordered SGD)."""
    return torch.topk(weights.float(), k).indices.to(torch.int32)


def uniform_select(n: int, k: int, *, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform without replacement."""
    if gumbel is None:
        gumbel = sample_gumbel((n,), generator, device)
    return torch.topk(gumbel, k).indices.to(torch.int32)


def select_minibatch(method: str, weights: torch.Tensor, k: int, *,
                     store: Optional["Store"] = None,
                     generator: Optional[torch.Generator] = None,
                     gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on the method; ``weights`` are the meta-batch's w_i(t)."""
    n = weights.shape[0]
    if k >= n:
        return torch.arange(n, dtype=torch.int32, device=weights.device)
    if method in ("es", "eswp", "loss"):
        if store is not None:
            return store.select(weights, k, generator=generator,
                                gumbel=gumbel)
        return gumbel_topk_select(weights, k, generator=generator,
                                  gumbel=gumbel)
    if method == "order":
        return topk_select(weights, k)
    if method in ("uniform", "baseline"):
        return uniform_select(n, k, device=weights.device,
                              generator=generator, gumbel=gumbel)
    raise ValueError(f"unknown selection method {method!r}")


def masked_select_kept(method: str, weights: torch.Tensor,
                       valid: torch.Tensor, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Select at most k of the VALID slots -> (n,) bool kept mask.

    Invalid slots (empty or pruned documents) take -inf keys, so they are
    picked only when fewer than k valid slots exist, and the final
    ``& valid`` drops them. ``gumbel`` (n,) injects the noise; with every
    slot valid the keys are ``gumbel_topk_select``'s.
    """
    n = weights.shape[0]
    if method in ("es", "eswp", "loss"):
        logw = torch.log(torch.clamp(weights.float(), min=_EPS))
        if gumbel is None:
            gumbel = sample_gumbel((n,), generator, weights.device)
        keys = logw + gumbel.to(logw.device)
    elif method == "order":
        keys = weights.float()
    elif method in ("uniform", "baseline"):
        if gumbel is None:
            gumbel = sample_gumbel((n,), generator, weights.device)
        keys = gumbel.to(weights.device).float()
    else:
        raise ValueError(f"unknown selection method {method!r}")
    keys = torch.where(valid, keys, torch.full_like(keys, float("-inf")))
    if k >= n:
        return valid
    kept = torch.zeros(n, dtype=torch.bool, device=weights.device)
    kept[torch.topk(keys, k).indices] = True
    return kept & valid


def selection_probs(weights: torch.Tensor) -> torch.Tensor:
    """Normalized p_i ~ w_i (for diagnostics and tests)."""
    w = torch.clamp(weights.float(), min=_EPS)
    return w / torch.sum(w)
