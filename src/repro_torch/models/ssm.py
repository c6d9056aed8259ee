"""Mamba2 / SSD (state-space duality) block: the chunked training scan and
the O(1) decode step (counterpart of ``repro/models/ssm.py:23-262``).

The reference runs all of it in XLA, without a Pallas kernel, and so does
the port in plain PyTorch. Shapes: d_inner = expand * d_model, nh =
d_inner / head_dim (P), state N, one B/C group.

SSD's contractions are explicit batched products whose intermediates stay
the size of the decay matrix ``L`` (B, nc, H, chunk, chunk): per chunk
``C B^T`` first, then scaled by ``L``, then times x (a 4-operand einsum
would take whatever order its operands give). The inter-chunk recurrence
is a sequential loop over the chunks where the reference runs
``jax.lax.associative_scan``: the same values in another float order.
Padding S to a multiple of the chunk with dt = 0 is exact (decay 1, no
input), as in the reference.

On a mesh (``ctx``; the reference's constraints at :191-192, :203) the
inner width is split over "mlp": ``w_z``, ``w_x``, ``conv_x`` and
``norm_scale`` hold this rank's d_inner / m channels, which are its
nh / m SSD heads. ``w_bc``, ``w_dt``, ``conv_bc``, ``dt_bias``, ``A_log``
and ``D`` are whole on every rank; each rank runs B and C whole and
slices dt, ``dt_bias``, ``A_log`` and ``D`` to its heads. Those
replicated leaves, and the input, feed work each rank does only for its
own heads (dt's product too is taken for them alone, as XLA splits it),
so they enter through ``ShardCtx.enter`` (their gradients
summed over "mlp"). The gated norm spans the ranks (``split_rmsnorm``),
and ``w_out`` is row-parallel (its partial sums all-reduced). The
depthwise convolution is per channel: no collective.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Init, Params, ShardCtx, split_rmsnorm


def mamba2_axes(lead: Tuple[int, ...]) -> Dict:
    """The logical axes of ``init_mamba2``'s tree (the reference's)."""
    la = ("layers",) * len(lead)
    return {"w_z": la + ("embed", "mlp"), "w_x": la + ("embed", "mlp"),
            "w_bc": la + ("embed", None), "w_dt": la + ("embed", None),
            "conv_x": la + (None, "mlp"), "conv_bc": la + (None, None),
            "dt_bias": la + (None,), "A_log": la + (None,),
            "D": la + (None,), "norm_scale": la + ("mlp",),
            "w_out": la + ("mlp", "embed")}


def ssm_cache_axes(stacked: Tuple[int, ...] = ()) -> Dict:
    la = ("layers",) * len(stacked)
    return {"ssm_state": la + ("batch", "mlp", None, None),
            "conv_x": la + ("batch", None, "mlp"),
            "conv_bc": la + ("batch", None, None)}


def init_mamba2(d_model: int, *, state: int, head_dim: int, expand: int,
                conv_width: int, lead: Tuple[int, ...], init: Init) -> Params:
    d_inner = expand * d_model
    nh = d_inner // head_dim

    def a_log(device):
        return torch.log(torch.linspace(1.0, float(nh), nh,
                                        dtype=torch.float32, device=device))
    return {
        "w_z": init.normal(lead + (d_model, d_inner)),
        "w_x": init.normal(lead + (d_model, d_inner)),
        "w_bc": init.normal(lead + (d_model, 2 * state)),
        "w_dt": init.normal(lead + (d_model, nh)),
        "conv_x": init.normal(lead + (conv_width, d_inner), 0.1),
        "conv_bc": init.normal(lead + (conv_width, 2 * state), 0.1),
        "dt_bias": init.full(lead + (nh,), 0.0),
        "A_log": init.row(lead + (nh,), a_log),
        "D": init.full(lead + (nh,), 1.0),
        "norm_scale": init.full(lead + (d_inner,), 1.0),
        "w_out": init.normal(lead + (d_inner, d_model)),
    }


REPLICATED = ("w_bc", "w_dt", "conv_bc", "dt_bias", "A_log", "D")


def _local(params: Params, x: torch.Tensor, nh: int, ctx: ShardCtx
           ) -> Tuple[Params, torch.Tensor, slice]:
    """The block's leaves and input as this rank's heads read them: the
    replicated leaves and x entering "mlp" (identity on one device) ->
    (leaves, x, this rank's slice of the nh heads)."""
    h0, hl = ctx.local("mlp", nh)
    p = dict(params)
    for name in REPLICATED:
        p[name] = ctx.enter(p[name], "mlp")
    return p, ctx.enter(x, "mlp"), slice(h0, h0 + hl)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): out[..., i, j] = sum_{k=j+1..i} x_k for
    i >= j (diagonal 0), -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, -math.inf)


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C): causal depthwise conv, no bias."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (B, S, H, P); dt (B, S, H), already softplus'ed;
    A (H,) negative; Bm, Cm (B, S, N). -> (y (B, S, H, P) in x's dtype,
    final state (B, H, P, N) f32)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    S_orig = S
    pad = (-S) % chunk
    if pad:
        # dt = 0 padding is exact: decay 1, x * dt = 0, no state change
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    f32 = torch.float32

    xdt = (x * dt[..., None]).to(f32)                        # (B,S,H,P)
    dA = dt.to(f32) * A.to(f32)                              # (B,S,H) <= 0
    # chunked views, heads before positions: (B, nc, H, chunk, ...)
    xc = xdt.reshape(Bsz, nc, chunk, H, Pd).permute(0, 1, 3, 2, 4)
    dAc = dA.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)  # (B,nc,H,ch)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    dA_cs = torch.cumsum(dAc, dim=-1)                        # (B,nc,H,ch)

    # intra-chunk: (C B^T) * L, then times x
    L = torch.exp(_segsum(dAc))                              # (B,nc,H,l,s)
    cb = Cc @ Bc.transpose(-1, -2)                           # (B,nc,l,s)
    y_diag = (cb[:, :, None] * L) @ xc                       # (B,nc,H,l,P)

    # chunk end-states: (x * decay)^T B
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)        # (B,nc,H,s)
    states = (xc * decay_states[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]                                     # (B,nc,H,P,N)

    # inter-chunk recurrence, chunk by chunk: the state entering chunk c
    chunk_decay = torch.exp(dA_cs[..., -1])                  # (B,nc,H)
    run = init_state.to(f32) if init_state is not None \
        else torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                  # (B,nc,H,P,N)

    # contribution of the entering states: (C entering^T) * decay
    state_decay = torch.exp(dA_cs)                           # (B,nc,H,l)
    y_off = (Cc[:, :, None] @ entering.transpose(-1, -2)) \
        * state_decay[..., None]                             # (B,nc,H,l,P)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, Pd)
    y = y.to(x.dtype)
    if pad:
        y = y[:, :S_orig]
    return y, run


def init_ssm_cache(batch: int, d_model: int, *, state: int, head_dim: int,
                   expand: int, conv_width: int,
                   stacked: Tuple[int, ...] = (),
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Float32 zeros: the SSM state and the pre-conv tails."""
    d_inner = expand * d_model
    nh = d_inner // head_dim
    lead = tuple(stacked)
    z = dict(dtype=torch.float32, device=device)
    return {
        "ssm_state": torch.zeros(lead + (batch, nh, head_dim, state), **z),
        "conv_x": torch.zeros(lead + (batch, conv_width - 1, d_inner), **z),
        "conv_bc": torch.zeros(lead + (batch, conv_width - 1, 2 * state),
                               **z),
    }


def mamba2_fwd(params: Params, x: torch.Tensor, *, state: int,
               head_dim: int, expand: int, chunk: int,
               return_state: bool = False, ctx: ShardCtx = ShardCtx()):
    """Full-sequence Mamba2 block: x (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode cache it leaves (the final SSM state
    and the PRE-conv tails of the conv inputs; on a mesh this rank's
    heads and channels)."""
    B, S, d = x.shape
    nh = expand * d // head_dim
    dt_ = x.dtype
    params, x, heads = _local(params, x, nh, ctx)

    z = x @ params["w_z"].to(dt_)
    xi = x @ params["w_x"].to(dt_)
    bc = x @ params["w_bc"].to(dt_)
    dt = x @ params["w_dt"][:, heads].to(dt_)

    xi_raw, bc_raw = xi, bc            # pre-conv tails feed the decode cache
    xi = F.silu(_causal_depthwise_conv(xi, params["conv_x"].to(dt_)))
    bc = F.silu(_causal_depthwise_conv(bc, params["conv_bc"].to(dt_)))
    Bm, Cm = bc.chunk(2, dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"][heads].float())
    A = -torch.exp(params["A_log"][heads].float())
    xh = xi.reshape(B, S, -1, head_dim)

    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    y = y + params["D"][heads].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, -1)
    y = split_rmsnorm(y * F.silu(z), params["norm_scale"], ctx, "mlp")
    out = ctx.psum(y @ params["w_out"].to(dt_), "mlp")
    if return_state:
        cw = params["conv_x"].shape[0]
        return out, {"ssm_state": final_state,
                     "conv_x": xi_raw[:, S - (cw - 1):].float(),
                     "conv_bc": bc_raw[:, S - (cw - 1):].float()}
    return out


def mamba2_decode(params: Params, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], *, state: int,
                  head_dim: int, expand: int, ctx: ShardCtx = ShardCtx()
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step: x (B, 1, d) -> (y (B, 1, d), new cache);
    on a mesh the cache is this rank's heads and channels."""
    B, _, d = x.shape
    nh = expand * d // head_dim
    dt_ = x.dtype
    params, x, heads = _local(params, x, nh, ctx)
    xt = x[:, 0]                                                 # (B, d)

    z = xt @ params["w_z"].to(dt_)
    xi = xt @ params["w_x"].to(dt_)
    bc = xt @ params["w_bc"].to(dt_)
    dt = xt @ params["w_dt"][:, heads].to(dt_)

    # depthwise causal conv over the stored tail and this token
    win_x = torch.cat([cache["conv_x"], xi.float()[:, None]], dim=1)
    win_bc = torch.cat([cache["conv_bc"], bc.float()[:, None]], dim=1)
    xi_c = F.silu(torch.einsum("bwc,wc->bc", win_x,
                               params["conv_x"].float()))
    bc_c = F.silu(torch.einsum("bwc,wc->bc", win_bc,
                               params["conv_bc"].float()))

    Bm, Cm = bc_c.chunk(2, dim=-1)                               # (B, N)
    dtp = F.softplus(dt.float() + params["dt_bias"][heads].float())
    A = -torch.exp(params["A_log"][heads].float())               # (nh,)
    xh = xi_c.reshape(B, -1, head_dim)                           # (B,nh,P)

    h = cache["ssm_state"]                                       # (B,nh,P,N)
    dA = torch.exp(dtp * A)                                      # (B, nh)
    h_new = (h * dA[:, :, None, None]
             + (dtp[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = (h_new @ Cm[:, None, :, None])[..., 0]                   # (B,nh,P)
    y = y + params["D"][heads].float()[None, :, None] * xh
    y = y.reshape(B, -1).to(dt_)
    y = split_rmsnorm(y * F.silu(z), params["norm_scale"], ctx, "mlp")
    out = ctx.psum(y @ params["w_out"].to(dt_), "mlp")[:, None, :]
    return out, {"ssm_state": h_new, "conv_x": win_x[:, 1:],
                 "conv_bc": win_bc[:, 1:]}
