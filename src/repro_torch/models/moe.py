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
auto grouping (``_auto_groups``), which is 1 without a device mesh; an
explicit G splits the tokens into G groups of their own capacity.

On a mesh (``ctx``; reference :84-162) x is this rank's rows and G and C
come from the global token count, so every rank routes as the reference's
partitioned program does. The rules place the work:

* "expert_group" over the data axes, G a multiple of their size: each
  rank routes its own G / dp groups, with no communication;
* a group spanning data ranks (G < dp: ``_auto_groups``' guard at a
  decode step, or ``moe_groups`` 1, whose "expert_group" is None): the
  group's tokens are all-gathered over the data axes (their gradient
  reduce-scattered), every rank of the group routes them alike (the same
  C, the same drops) and combines only its own rows;
* "expert" over "model" (EP): the rank runs its E / m experts on every
  slot of the group (the tokens are there already), then the expert
  outputs are all-gathered over "model" before the combine, as the
  reference un-shards them (:145);
* "moe_mlp" over "model" (TP): the rank runs every expert on its d_ff /
  m slice, and the ``w_down`` partial sums are all-reduced (``psum``);
* "expert_cap" over the data axes (TP with ``moe_groups`` 1, the paper's
  global dispatch): the rank runs its C / dp slots of each expert, and
  the outputs are all-gathered over the data axes along C.

The dispatched tokens enter the experts through ``enter`` (identity
forward, the gradient summed over "model", whose ranks each run a part
of the experts); the router and the combine are repeated on every
"model" rank. A layout the rules give that this scheme cannot produce
raises, naming the rule.

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
from .layers import Init, Params, ShardCtx


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


def _auto_groups(ctx: ShardCtx, T: int, n_experts: int) -> int:
    """The reference's auto grouping (:61-81): G is the product of the
    "batch" axes' sizes (1 without a mesh, or when G does not divide T),
    halved while a group would route fewer than 2E tokens. ``T`` is the
    global token count (the reference's partitioner sees global shapes):
    a decode step of B tokens often ends with G below the data size."""
    if ctx.mesh is None or not ctx.dims("batch"):
        return 1
    g = ctx.size("batch")
    if g <= 0 or T % g:
        return 1
    while g > 1 and (T // g) < 2 * n_experts:
        g //= 2
    return g if g > 0 and T % g == 0 else 1


def _placement(ctx: ShardCtx, G: int) -> Tuple[int, int]:
    """(groups this rank routes, data ranks a group spans) for G groups
    over the "batch" axes: G / dp local groups each, or one group shared
    by dp / G ranks."""
    dp = ctx.size("batch")
    for rule in ("expert_group", "expert_cap"):
        if ctx.dims(rule) not in ((), ctx.dims("batch")):
            raise NotImplementedError(
                f"{rule!r} over {ctx.dims(rule)}: the MoE dispatch splits "
                f"it over the batch's axes {ctx.dims('batch')} or not at "
                f"all")
    if G % dp == 0:
        return G // dp, 1
    if dp % G == 0:
        return 1, dp // G
    raise NotImplementedError(
        f"'expert_group': {G} dispatch groups over {dp} data ranks (each "
        f"rank takes whole groups, or a group whole ranks)")


def dispatch_layout(ctx: ShardCtx, T: int, n_experts: int, top_k: int,
                    capacity_factor: float = 1.25, n_groups: int = 0
                    ) -> Tuple[int, int, int, int, int]:
    """The dispatch of ``T`` global tokens under ``ctx``'s rules -> (G,
    tokens a group, capacity C, groups this rank routes, data ranks a
    group spans); raises for a layout the dispatch cannot produce,
    naming the rule."""
    E = n_experts
    G = _auto_groups(ctx, T, E) if n_groups == 0 else n_groups
    if T % G:
        G = 1
    Tg = T // G
    C = capacity(Tg, E, top_k, capacity_factor)
    Gl, span = _placement(ctx, G)
    if ctx.size("expert") > 1 and ctx.size("moe_mlp") > 1:
        raise NotImplementedError("'expert' and 'moe_mlp' both sharded: "
                                  "experts split one way only")
    ctx.local("expert", E)                # each splits evenly, or raises
    ctx.local("expert_cap", C)
    return G, Tg, C, Gl, span


def moe_fwd(params: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 0,
            ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), in x's dtype; on a mesh x is this rank's
    rows and ``params`` its shards. ``n_groups``: 0 = auto
    (``_auto_groups``), G = explicit (1 when G does not divide the global
    token count)."""
    B, S, d = x.shape
    E, k = n_experts, top_k
    _, Tg, C, Gl, span = dispatch_layout(
        ctx, B * S * ctx.size("batch"), E, k, capacity_factor, n_groups)
    dt = x.dtype
    own = 0
    if span == 1:
        xt = x.reshape(Gl, Tg, d)
    else:                  # the group's tokens, from every rank it spans
        c = ctx.coord("batch")
        grp = c // span
        xt = ctx.gather(x.reshape(B * S, d), "batch", 0).narrow(
            0, grp * Tg, Tg)[None]
        own = (c % span) * B * S
    logits = (xt @ params["router"].to(dt)).float()
    gates, eidx, slot, keep = route(logits, k, C)

    # scatter the pairs into (Gl, E*C + 1, d); the overflow row is dropped.
    # On a mesh the buffer holds this rank's experts and capacity slots
    # only: another rank's pairs go to the overflow row
    e_lo, e_n = ctx.local("expert", E)
    c_lo, c_n = ctx.local("expert_cap", C)
    xe = ctx.enter(ctx.enter(xt, "expert"), "moe_mlp")
    tok_idx = torch.arange(Tg, device=x.device).repeat_interleave(k)
    src = xe[:, tok_idx]                                  # (Gl, Tgk, d)
    rows = slot
    if (e_n, c_n) != (E, C):
        flat_e = eidx.reshape(Gl, Tg * k)
        pos = slot - flat_e * C
        mine = (keep & (flat_e >= e_lo) & (flat_e < e_lo + e_n)
                & (pos >= c_lo) & (pos < c_lo + c_n))
        rows = torch.where(mine, (flat_e - e_lo) * c_n + pos - c_lo,
                           torch.full_like(slot, e_n * c_n))
    buf = torch.zeros(Gl, e_n * c_n + 1, d, dtype=dt, device=x.device)
    buf = buf.scatter(1, rows[..., None].expand(Gl, Tg * k, d), src)
    buf = buf[:, :e_n * c_n].reshape(Gl, e_n, c_n, d)

    # the experts' SwiGLU, batched over (Gl, E, C): this rank's experts,
    # d_ff slice and slots
    g_ = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    h = F.silu(g_) * u
    out = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(dt))
    out = ctx.psum(out, "moe_mlp")             # TP: the d_ff partial sums
    out = ctx.unshard(out, "expert", 1)        # EP: every expert's outputs
    out = ctx.gather(out, "expert_cap", 2)     # every capacity slot

    # combine: each pair's slot output times its gate (0 when dropped),
    # summed over a token's k pairs in k order (the reference's
    # scatter-add); a spanning group's rank combines its own rows
    n = B * S if span > 1 else Tg
    slot = slot[:, own * k:(own + n) * k]
    w = (gates.reshape(Gl, Tg * k)[:, own * k:(own + n) * k]
         * keep[:, own * k:(own + n) * k].to(torch.float32)).to(dt)
    out_flat = torch.cat([out.reshape(Gl, E * C, d),
                          torch.zeros(Gl, 1, d, dtype=dt, device=x.device)],
                         dim=1)
    per_slot = (out_flat.gather(1, slot[..., None].expand(Gl, n * k, d))
                * w[..., None]).reshape(Gl, n, k, d)
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
