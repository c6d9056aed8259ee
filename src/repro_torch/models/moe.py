"""Top-k Mixture-of-Experts with capacity-based, optionally grouped
dispatch (counterpart of ``repro/models/moe.py:34-171``).

The reference's static-shape scheme, kept exactly:

* router logits ``x @ router`` in the compute dtype, then float32;
* the top k experts of each token, the gates a softmax over those k;
* each (token, choice) pair takes the next free slot of its expert through
  a one-hot cumsum in token-major, k-minor order, so earlier tokens win
  the capacity ``C``; a pair past ``C`` goes to the dropped row ``E * C``;
* the kept pairs are scattered into an (G, E, C, d) buffer, the experts'
  SwiGLU runs batched over it, and each token gathers its kept slots'
  outputs weighted by their gates (a dropped pair contributes zero).

Capacity comes from the token count of the call: a scoring forward over
the meta-batch and a training forward over the minibatch route with
different ``C``, as in the reference. ``n_groups`` 0 is the reference's
auto grouping, which is 1 without a device mesh; an explicit G splits the
tokens into G groups of their own capacity.

Ties among router logits go to the lower expert index, as
``jax.lax.top_k`` orders them: the top k come from a stable descending
sort (``core.selection.top_k``). The expert products are batched (bmm),
so the "selective" remat policy recomputes them, as
``dots_with_no_batch_dims_saveable`` does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.selection import top_k as _top_k
from .layers import Init, Params


def moe_axes(lead: Tuple[int, ...]) -> Dict:
    """The logical axes of ``init_moe``'s tree (the reference's)."""
    la = ("layers",) * len(lead)
    return {"router": la + ("embed", None),
            "w_gate": la + ("expert", "embed", "moe_mlp"),
            "w_up": la + ("expert", "embed", "moe_mlp"),
            "w_down": la + ("expert", "moe_mlp", "embed")}


def init_moe(d: int, f: int, n_experts: int, lead: Tuple[int, ...],
             init: Init) -> Params:
    return {"router": init.normal(lead + (d, n_experts)),
            "w_gate": init.normal(lead + (n_experts, d, f)),
            "w_up": init.normal(lead + (n_experts, d, f)),
            "w_down": init.normal(lead + (n_experts, f, d))}


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25, multiple_of: int = 8) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    c = max(multiple_of, (c + multiple_of - 1) // multiple_of * multiple_of)
    return min(c, n_tokens)


def route(logits: torch.Tensor, k: int, C: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 router logits (G, Tg, E) -> (gates (G, Tg, k), expert ids
    (G, Tg, k), slot (G, Tg*k) into the (E*C + 1)-row buffer, keep (G,
    Tg*k)): slots in token-major, k-minor order, overflow to row E*C."""
    G, Tg, E = logits.shape
    gates, eidx = _top_k(logits, k)
    gates = torch.softmax(gates, dim=-1)
    flat_e = eidx.reshape(G, Tg * k)
    oh = F.one_hot(flat_e, E).to(torch.int32)            # (G, Tgk, E)
    pos = torch.cumsum(oh, dim=1) - oh
    pos_in_e = torch.sum(pos * oh, dim=-1)               # (G, Tgk)
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    return gates, eidx, slot, keep


def moe_fwd(params: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 0
            ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), in x's dtype. ``n_groups``: 0 = auto (1
    on one device), G = explicit (1 when G does not divide B*S)."""
    B, S, d = x.shape
    T = B * S
    E, k = n_experts, top_k
    G = 1 if n_groups == 0 else n_groups
    if T % G:
        G = 1
    Tg = T // G
    C = capacity(Tg, E, k, capacity_factor)
    dt = x.dtype
    xt = x.reshape(G, Tg, d)
    logits = (xt @ params["router"].to(dt)).float()
    gates, _, slot, keep = route(logits, k, C)

    # scatter the pairs into (G, E*C + 1, d); the overflow row is dropped
    tok_idx = torch.arange(Tg, device=x.device).repeat_interleave(k)
    src = xt[:, tok_idx]                                  # (G, Tgk, d)
    index = slot[..., None].expand(G, Tg * k, d)
    buf = torch.zeros(G, E * C + 1, d, dtype=dt, device=x.device)
    buf = buf.scatter(1, index, src)
    buf = buf[:, :E * C].reshape(G, E, C, d)

    # the experts' SwiGLU, batched over (G, E, C)
    g_ = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    h = F.silu(g_) * u
    out = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(dt))

    # combine: each pair's slot output times its gate (0 when dropped),
    # summed over a token's k pairs in k order (the reference's scatter-add)
    out_flat = torch.cat([out.reshape(G, E * C, d),
                          torch.zeros(G, 1, d, dtype=dt, device=x.device)],
                         dim=1)
    w = (gates.reshape(G, Tg * k) * keep.to(torch.float32)).to(dt)
    per_slot = (out_flat.gather(1, index) * w[..., None]).reshape(
        G, Tg, k, d)
    y = per_slot[:, :, 0]
    for j in range(1, k):
        y = y + per_slot[:, :, j]
    return y.reshape(B, S, d)


def moe_aux_loss(logits: torch.Tensor, eidx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """Switch load-balancing loss, E * sum_e f_e * p_e, over logits (T, E)
    and the chosen experts (..., k) (the first choice counts)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    oh = F.one_hot(eidx[..., 0].reshape(-1), n_experts).to(torch.float32)
    ce = oh.mean(dim=0)
    return n_experts * torch.sum(me * ce)
