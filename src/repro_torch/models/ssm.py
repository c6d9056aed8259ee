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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Params, rmsnorm, winit


def init_mamba2(d_model: int, *, state: int, head_dim: int, expand: int,
                conv_width: int, lead: Tuple[int, ...], device,
                gen: torch.Generator) -> Params:
    d_inner = expand * d_model
    nh = d_inner // head_dim
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, float(nh), nh, **f32))
    return {
        "w_z": winit(lead + (d_model, d_inner), device, gen),
        "w_x": winit(lead + (d_model, d_inner), device, gen),
        "w_bc": winit(lead + (d_model, 2 * state), device, gen),
        "w_dt": winit(lead + (d_model, nh), device, gen),
        "conv_x": winit(lead + (conv_width, d_inner), device, gen, 0.1),
        "conv_bc": winit(lead + (conv_width, 2 * state), device, gen, 0.1),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), **f32),
        "norm_scale": torch.ones(lead + (d_inner,), **f32),
        "w_out": winit(lead + (d_inner, d_model), device, gen),
    }


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
               return_state: bool = False):
    """Full-sequence Mamba2 block: x (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode cache it leaves (the final SSM state
    and the PRE-conv tails of the conv inputs)."""
    B, S, d = x.shape
    d_inner = expand * d
    nh = d_inner // head_dim
    dt_ = x.dtype

    z = x @ params["w_z"].to(dt_)
    xi = x @ params["w_x"].to(dt_)
    bc = x @ params["w_bc"].to(dt_)
    dt = x @ params["w_dt"].to(dt_)

    xi_raw, bc_raw = xi, bc            # pre-conv tails feed the decode cache
    xi = F.silu(_causal_depthwise_conv(xi, params["conv_x"].to(dt_)))
    bc = F.silu(_causal_depthwise_conv(bc, params["conv_bc"].to(dt_)))
    Bm, Cm = bc.chunk(2, dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xi.reshape(B, S, nh, head_dim)

    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    out = y @ params["w_out"].to(dt_)
    if return_state:
        cw = params["conv_x"].shape[0]
        return out, {"ssm_state": final_state,
                     "conv_x": xi_raw[:, S - (cw - 1):].float(),
                     "conv_bc": bc_raw[:, S - (cw - 1):].float()}
    return out


def mamba2_decode(params: Params, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], *, state: int,
                  head_dim: int, expand: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step: x (B, 1, d) -> (y (B, 1, d), new cache)."""
    B, _, d = x.shape
    d_inner = expand * d
    nh = d_inner // head_dim
    dt_ = x.dtype
    xt = x[:, 0]                                                 # (B, d)

    z = xt @ params["w_z"].to(dt_)
    xi = xt @ params["w_x"].to(dt_)
    bc = xt @ params["w_bc"].to(dt_)
    dt = xt @ params["w_dt"].to(dt_)

    # depthwise causal conv over the stored tail and this token
    win_x = torch.cat([cache["conv_x"], xi.float()[:, None]], dim=1)
    win_bc = torch.cat([cache["conv_bc"], bc.float()[:, None]], dim=1)
    xi_c = F.silu(torch.einsum("bwc,wc->bc", win_x,
                               params["conv_x"].float()))
    bc_c = F.silu(torch.einsum("bwc,wc->bc", win_bc,
                               params["conv_bc"].float()))

    Bm, Cm = bc_c.chunk(2, dim=-1)                               # (B, N)
    dtp = F.softplus(dt.float() + params["dt_bias"].float())     # (B, nh)
    A = -torch.exp(params["A_log"].float())                      # (nh,)
    xh = xi_c.reshape(B, nh, head_dim)                           # (B,nh,P)

    h = cache["ssm_state"]                                       # (B,nh,P,N)
    dA = torch.exp(dtp * A)                                      # (B, nh)
    h_new = (h * dA[:, :, None, None]
             + (dtp[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = (h_new @ Cm[:, None, :, None])[..., 0]                   # (B,nh,P)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, d_inner).to(dt_)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    out = (y @ params["w_out"].to(dt_))[:, None, :]              # (B,1,d)
    return out, {"ssm_state": h_new, "conv_x": win_x[:, 1:],
                 "conv_bc": win_bc[:, 1:]}
