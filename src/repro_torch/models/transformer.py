"""The LMs of all six families: init, hidden states, per-sample and
per-segment loss (counterpart of ``repro/models/transformer.py``: the
blocks :80-166, ``init_lm`` :204, ``lm_hidden`` :270, ``encode`` :355,
``lm_per_sample_loss`` :378, ``lm_per_segment_loss`` :397).

Parameters are a dict mirroring the JAX pytree, with the layer stack
stacked along a leading L axis (``layers/attn/wq`` is (L, d, H*hd)):

    embed/tok (V, d) [, embed/head (d, V)]   final_norm/scale (d,)
    dense: layers/ln1, ln2 /scale (L, d), layers/attn/wq, wk, wv, wo
           [, bq, bk, bv], layers/mlp/w_gate, w_up (L, d, f), w_down
    moe:   the dense tree with layers/moe/router (L, d, E), w_gate, w_up
           (L, E, d, f), w_down (L, E, f, d) for the MLP [, layers/
           dense_res/w_gate, w_up, w_down: arctic's dense residual]
    ssm:   layers/ln1/scale, layers/mamba/* (L, ...)
    hybrid: layers/ln1, layers/mamba/* led by (n_sites, every), and one
           dense block ``shared`` (no stack) applied at each site's end
    vlm:   dense layers/* led by (n_sites, every); cross/ln1, ln2, attn,
           mlp, gate_attn, gate_mlp (n_sites, 1): a gated cross-attention
           block to the image embeddings at each site's end
    encdec: dense layers/* (L,) and cross/attn, cross/ln (L,): each
           decoder layer attends to itself, then (after cross/ln) to the
           encoder's output, then runs its MLP; encoder/* (a dense stack of
           num_encoder_layers), frontend_proj (frontend_dim, d) and
           enc_final_norm

Two forwards compute the same per-sample loss:

* ``scoring=False``: the training path in plain autograd, as the
  reference's XLA path, with its three memory knobs: each block under the
  config's ``remat_policy`` (when gradients are on), query chunks of
  ``attn_chunk_q`` in the attention, and sequence chunks of ``seq_chunk``
  in the cross-entropy;
* ``scoring=True``: the no-grad ES scoring forward, with every causal
  self-attention through the flash-attention kernel and the loss through
  the fused cross-entropy kernel, which reads the (V, d) embedding table
  without a transpose; the encoder's self-attention takes the same kernel
  without the causal mask. The MoE dispatch, the Mamba2 blocks and
  cross-attention are plain PyTorch on both paths, as they are XLA in the
  reference.

vlm and encdec read their memory from the batch (``image_embeds`` (B,
n_img, d), ``frames`` (B, T, frontend_dim)), as the reference does. The
vlm's gates start at 0, and tanh(0) = 0: a fresh vlm does not reach its
cross-attention until they move.

Packed rows (``positions`` and ``segment_ids``) take the training path
with segment-isolated attention (dense and moe only: the SSM recurrences
have no segment reset); ``lm_per_segment_loss`` is the packed step's one
differentiated forward.

On a mesh (``ctx``, the dense, MoE, SSM and hybrid families,
``MESH_FAMILIES``; reference :158-178, :283, :361) every leaf is this
rank's shard of the reference's (``param_axes``): heads, the MLP's hidden
width (arctic's dense residual's too), a Mamba2 block's inner width and
SSD heads (``models/ssm.py``) and the vocabulary over "model"; the
experts over "model" under EP ("expert") or their d_ff under TP
("moe_mlp"); and under FSDP the "embed" dimension over the data axes,
all-gathered inside each layer's remat region (so the gathered copy is
recomputed, not kept) and its gradient reduce-scattered. zamba2's shared
block takes the dense rules with its own axes (``param_axes(cfg)
["shared"]``) at each site. The batch is this rank's rows; the MoE
dispatch groups them as ``models/moe.py`` says. The vlm and encdec
families on a mesh are a later slice (``MESH_LATER``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import dataclasses
import zlib

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..kernels.xent.ops import per_sample_xent_fused
from .attention import attn_axes, cross_attn, init_attn, mha
from .layers import (Axes, Init, LeafSpec, LeafSpecs, Params, ShardCtx,
                     apply_norm, embed_tokens, embedding_axes,
                     init_embedding, init_mlp, init_norm, local_shape,
                     mlp_axes, mlp_fwd, norm_axes, unembed_matrix,
                     unembed_table, winit)
from .losses import per_sample_xent, per_segment_xent
from .moe import init_moe, moe_axes, moe_fwd
from .ssm import init_mamba2, mamba2_axes, mamba2_fwd

# the slice that brings each family onto a mesh (refused until then)
MESH_LATER = {
    "vlm": "vlm and encdec on a mesh (cross-attention) are a later slice",
    "encdec": "vlm and encdec on a mesh (cross-attention) are a later "
              "slice",
}


MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_mesh(cfg: ModelConfig, ctx: ShardCtx) -> None:
    """Refuse a family that does not run on a mesh yet, with its reason."""
    if ctx.mesh is not None and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: {MESH_LATER[cfg.family]}")


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _init_dense_block(cfg: ModelConfig, lead: Tuple[int, ...],
                      init: Init) -> Dict:
    """Attention + MLP (or MoE, with arctic's dense residual) block."""
    d = cfg.d_model
    p: Dict = {"attn": init_attn(d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim(), cfg.qkv_bias,
                                 lead, init)}
    ln1 = init_norm(cfg.norm_kind, d, lead, init)
    if ln1 is not None:
        p["ln1"] = ln1
        p["ln2"] = init_norm(cfg.norm_kind, d, lead, init)
    if cfg.num_experts > 0:
        p["moe"] = init_moe(d, cfg.d_ff, cfg.num_experts, lead, init)
        if cfg.moe_dense_residual:
            p["dense_res"] = init_mlp("swiglu", d, cfg.dense_residual_d_ff,
                                      lead, init)
    else:
        p["mlp"] = init_mlp(cfg.mlp_kind, d, cfg.d_ff, lead, init)
    return p


def _init_mamba_block(cfg: ModelConfig, lead: Tuple[int, ...],
                      init: Init) -> Dict:
    p: Dict = {}
    ln1 = init_norm(cfg.norm_kind, cfg.d_model, lead, init)
    if ln1 is not None:
        p["ln1"] = ln1
    p["mamba"] = init_mamba2(cfg.d_model, state=cfg.ssm_state,
                             head_dim=cfg.ssm_head_dim,
                             expand=cfg.ssm_expand,
                             conv_width=cfg.ssm_conv_width, lead=lead,
                             init=init)
    return p


def _init_cross_block(cfg: ModelConfig, lead: Tuple[int, ...],
                      init: Init) -> Dict:
    """Gated cross-attention block (llama-3.2-vision): the gates start at
    zero."""
    d = cfg.d_model
    p: Dict = {}
    ln1 = init_norm(cfg.norm_kind, d, lead, init)
    if ln1 is not None:
        p["ln1"] = ln1
        p["ln2"] = init_norm(cfg.norm_kind, d, lead, init)
    p["attn"] = init_attn(d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim(), False, lead, init)
    p["mlp"] = init_mlp(cfg.mlp_kind, d, cfg.d_ff, lead, init)
    p["gate_attn"] = init.full(lead + (1,), 0.0)
    p["gate_mlp"] = init.full(lead + (1,), 0.0)
    return p


def n_sites(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_sites, layers a site) of the hybrid's or the vlm's grouped
    stack."""
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" \
        else cfg.cross_attn_every
    assert every > 0 and cfg.num_layers % every == 0, (cfg.num_layers, every)
    return cfg.num_layers // every, every


def shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared block: dense attention + MLP at d_model width
    (the reference's ``dataclasses_replace_dense``)."""
    return dataclasses.replace(cfg, family="dense", num_experts=0)


def _dense_block_axes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Axes:
    a: Axes = {"attn": attn_axes(cfg.qkv_bias, lead)}
    n = norm_axes(cfg.norm_kind, lead)
    if n is not None:
        a["ln1"], a["ln2"] = n, dict(n)
    if cfg.num_experts > 0:
        a["moe"] = moe_axes(lead)
        if cfg.moe_dense_residual:
            a["dense_res"] = mlp_axes("swiglu", lead)
    else:
        a["mlp"] = mlp_axes(cfg.mlp_kind, lead)
    return a


def _mamba_block_axes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Axes:
    a: Axes = {"mamba": mamba2_axes(lead)}
    n = norm_axes(cfg.norm_kind, lead)
    if n is not None:
        a["ln1"] = n
    return a


def param_axes(cfg: ModelConfig) -> Axes:
    """The logical axes of ``init_lm``'s tree: the reference ``init_lm``'s
    second result (``repro/models/transformer.py:204-257``)."""
    axes: Axes = {"embed": embedding_axes(cfg.tie_embeddings)}
    fn = norm_axes(cfg.norm_kind, ())
    if fn is not None:
        axes["final_norm"] = fn
    if cfg.family in ("dense", "moe"):
        axes["layers"] = _dense_block_axes(cfg, (cfg.num_layers,))
    elif cfg.family == "ssm":
        axes["layers"] = _mamba_block_axes(cfg, (cfg.num_layers,))
    elif cfg.family == "hybrid":
        axes["layers"] = _mamba_block_axes(cfg, n_sites(cfg))
        axes["shared"] = _dense_block_axes(shared_cfg(cfg), ())
    elif cfg.family == "vlm":
        ns, k = n_sites(cfg)
        axes["layers"] = _dense_block_axes(cfg, (ns, k))
        cross: Axes = {"attn": attn_axes(False, (ns,)),
                       "mlp": mlp_axes(cfg.mlp_kind, (ns,)),
                       "gate_attn": ("layers", None),
                       "gate_mlp": ("layers", None)}
        n = norm_axes(cfg.norm_kind, (ns,))
        if n is not None:
            cross["ln1"], cross["ln2"] = n, dict(n)
        axes["cross"] = cross
    elif cfg.family == "encdec":
        L = (cfg.num_layers,)
        axes["layers"] = _dense_block_axes(cfg, L)
        axes["cross"] = {"attn": attn_axes(False, L)}
        n = norm_axes(cfg.norm_kind, L)
        if n is not None:
            axes["cross"]["ln"] = n
        axes["encoder"] = _dense_block_axes(cfg, (cfg.num_encoder_layers,))
        axes["frontend_proj"] = (None, "embed")
        efn = norm_axes(cfg.norm_kind, ())
        if efn is not None:
            axes["enc_final_norm"] = efn
    else:
        raise ValueError(cfg.family)
    return axes


def _layer_axes(axes: Axes, lead: int = 1) -> Axes:
    """A stacked block's axes without its ``lead`` leading "layers"."""
    if isinstance(axes, dict):
        return {k: _layer_axes(v, lead) for k, v in axes.items()}
    return axes[lead:]


def block_axes(cfg: ModelConfig, ctx: ShardCtx
               ) -> Tuple[Optional[Axes], Optional[Axes]]:
    """On a mesh, (one layer's axes, zamba2's shared block's): what FSDP
    gathers in a block; (None, None) without a mesh."""
    if ctx.mesh is None:
        return None, None
    axes = param_axes(cfg)
    lead = 2 if cfg.family in ("hybrid", "vlm") else 1
    return _layer_axes(axes["layers"], lead), axes.get("shared")


def _init_local(specs, axes, gen: Optional[torch.Generator], device,
                ctx: ShardCtx) -> Dict:
    """This rank's shards of the leaves ``specs`` describes (``_init_tree``
    with ``LeafSpecs``: the init functions' own distributions), made
    directly at their local shapes, never the global tensor. A shard's
    draws come from a generator seeded by ``gen``'s first draw, the
    leaf's name and the shard's coordinates, so the ranks that hold the
    same shard hold the same values."""
    device = torch.device(device)
    meta = device.type == "meta"
    base = 0 if meta else int(torch.randint(
        0, 2 ** 62, (1,), generator=gen, device=gen.device))

    def make(path: str, spec: LeafSpec, axes):
        shape = local_shape(spec.shape, axes, ctx)
        if meta:
            return torch.empty(shape, device=device)
        if spec.kind == "full":
            return Init(device, None).full(shape, spec.arg)
        if spec.kind == "row":
            lo, n = ctx.local(axes[-1], spec.shape[-1])
            return spec.arg(device)[lo:lo + n].expand(shape).clone()
        coords = tuple(ctx.coord(a) for a in axes)
        seed = (base + zlib.crc32(f"{path}{coords}".encode())) % 2 ** 63
        g = torch.Generator(device=device).manual_seed(seed)
        return winit(shape, device, g, spec.arg)

    def walk(tree, axes, path):
        if isinstance(tree, dict):
            return {k: walk(v, axes[k], f"{path}/{k}")
                    for k, v in tree.items()}
        return make(path, tree, axes)
    return walk(specs, axes, "")


def _init_tree(cfg: ModelConfig, init) -> Dict:
    """``init_lm``'s tree, each leaf made by ``init`` (an ``Init``, or
    ``LeafSpecs`` for a mesh rank's shards)."""
    d = cfg.d_model
    params: Dict = {"embed": init_embedding(cfg.vocab_size, d,
                                            cfg.tie_embeddings, init)}
    fn = init_norm(cfg.norm_kind, d, (), init)
    if fn is not None:
        params["final_norm"] = fn
    if cfg.family in ("dense", "moe"):
        params["layers"] = _init_dense_block(cfg, (cfg.num_layers,), init)
    elif cfg.family == "ssm":
        params["layers"] = _init_mamba_block(cfg, (cfg.num_layers,), init)
    elif cfg.family == "hybrid":
        params["layers"] = _init_mamba_block(cfg, n_sites(cfg), init)
        params["shared"] = _init_dense_block(shared_cfg(cfg), (), init)
    elif cfg.family == "vlm":
        ns, k = n_sites(cfg)
        params["layers"] = _init_dense_block(cfg, (ns, k), init)
        params["cross"] = _init_cross_block(cfg, (ns,), init)
    elif cfg.family == "encdec":
        L = (cfg.num_layers,)
        params["layers"] = _init_dense_block(cfg, L, init)
        params["cross"] = {"attn": init_attn(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(),
            False, L, init)}
        lnc = init_norm(cfg.norm_kind, d, L, init)
        if lnc is not None:
            params["cross"]["ln"] = lnc
        params["encoder"] = _init_dense_block(
            cfg, (cfg.num_encoder_layers,), init)
        params["frontend_proj"] = init.normal((cfg.frontend_dim or d, d))
        efn = init_norm(cfg.norm_kind, d, (), init)
        if efn is not None:
            params["enc_final_norm"] = efn
    else:
        raise ValueError(cfg.family)
    return params


def init_lm(cfg: ModelConfig, gen: Optional[torch.Generator], device,
            ctx: ShardCtx = ShardCtx()) -> Dict:
    """Random parameters with the reference's distributions: N(0, 0.02^2)
    weights (the SSM convolutions 0.1^2), zero biases, unit norm scales,
    ``A_log`` = log(1..nh), all float32 (``param_dtype`` applied last).
    Drawn from ``gen`` on ``device``; the draws differ from JAX's (tests
    carry JAX parameters across with ``bridge``). On a mesh, this rank's
    shards (``_init_local``)."""
    if ctx.mesh is None:
        params = _init_tree(cfg, Init(device, gen))
    else:
        check_mesh(cfg, ctx)
        params = _init_local(_init_tree(cfg, LeafSpecs()), param_axes(cfg),
                             gen, device, ctx)
    pdt = dtype_of(cfg.param_dtype)
    if pdt != torch.float32:
        params = tree_map(lambda p: p.to(pdt), params)
    return params


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _unstack(tree, n: int) -> list:
    """Per-layer views of the stacked layer params (``unbind``, whose
    backward stacks the layer grads once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def ffn(cfg: ModelConfig, p: Params, h: torch.Tensor,
        ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The block's feed-forward: MoE (+ the dense residual) or the MLP."""
    if cfg.num_experts > 0:
        y = moe_fwd(p["moe"], h, n_experts=cfg.num_experts,
                    top_k=cfg.num_experts_per_tok,
                    capacity_factor=cfg.capacity_factor,
                    n_groups=cfg.moe_groups, ctx=ctx)
        if cfg.moe_dense_residual:
            y = y + mlp_fwd("swiglu", p["dense_res"], h, ctx)
        return y
    return mlp_fwd(cfg.mlp_kind, p["mlp"], h, ctx)


def _self_attn(cfg: ModelConfig, p: Params, h: torch.Tensor, scoring: bool,
               causal: bool = True, positions: Optional[torch.Tensor] = None,
               segment_ids: Optional[torch.Tensor] = None,
               ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    return mha(p, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
               head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta,
               chunk_q=cfg.attn_chunk_q, causal=causal, scoring=scoring,
               positions=positions, segment_ids=segment_ids, ctx=ctx)


def _cross(cfg: ModelConfig, p: Params, h: torch.Tensor,
           memory: torch.Tensor) -> torch.Tensor:
    return cross_attn(p, h, memory, n_heads=cfg.num_heads,
                      n_kv=cfg.num_kv_heads,
                      head_dim=cfg.resolved_head_dim())


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scoring: bool, positions: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 causal: bool = True, ctx: ShardCtx = ShardCtx(),
                 axes: Optional[Axes] = None) -> torch.Tensor:
    """Attention + feed-forward; ``causal=False`` is the encoder's. On a
    mesh ``axes`` (the layer's) says which leaves FSDP gathers here."""
    p = ctx.gather_params(p, axes)
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    x = x + _self_attn(cfg, p["attn"], h, scoring, causal, positions,
                       segment_ids, ctx)
    h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    return x + ffn(cfg, p, h, ctx)


def _mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 ctx: ShardCtx = ShardCtx(),
                 axes: Optional[Axes] = None) -> torch.Tensor:
    """Norm + Mamba2; on a mesh ``axes`` (the layer's) says which leaves
    FSDP gathers here."""
    p = ctx.gather_params(p, axes)
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    return x + mamba2_fwd(p["mamba"], h, state=cfg.ssm_state,
                          head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                          chunk=cfg.ssm_chunk, ctx=ctx)


def gated_cross_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      attend) -> torch.Tensor:
    """The vlm's gated cross-attention block with ``attend(attn params,
    h) -> y`` as its cross-attention: tanh-gated cross-attention, then a
    tanh-gated MLP."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    x = x + torch.tanh(p["gate_attn"].to(x.dtype)) * attend(p["attn"], h)
    h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    return x + torch.tanh(p["gate_mlp"].to(x.dtype)) * mlp_fwd(
        cfg.mlp_kind, p["mlp"], h)


def decoder_layer(cfg: ModelConfig, p: Params, cp: Params, x: torch.Tensor,
                  self_attend, cross_attend) -> torch.Tensor:
    """An encdec decoder layer with ``self_attend(attn params, h)`` and
    ``cross_attend(attn params, h)``: self-attention, cross-attention to
    the encoder's output after ``cp["ln"]``, then the MLP."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    x = x + self_attend(p["attn"], h)
    h = apply_norm(cfg.norm_kind, x, cp.get("ln"))
    x = x + cross_attend(cp["attn"], h)
    h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    return x + mlp_fwd(cfg.mlp_kind, p["mlp"], h)


def _cross_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    return gated_cross_block(cfg, p, x,
                             lambda pa, h: _cross(cfg, pa, h, memory))


def _decoder_block(cfg: ModelConfig, p: Params, cp: Params, x: torch.Tensor,
                   enc: torch.Tensor, scoring: bool) -> torch.Tensor:
    return decoder_layer(cfg, p, cp, x,
                         lambda pa, h: _self_attn(cfg, pa, h, scoring),
                         lambda pa, h: _cross(cfg, pa, h, enc))


# "selective" keeps the outputs of the products without a batch dimension,
# as jax.checkpoint_policies.dots_with_no_batch_dims_saveable does: the
# q/k/v/o and MLP projections (``x @ W`` dispatches to mm, with a bias to
# addmm). Everything else of the layer is recomputed in the backward: the
# attention's batched products (bmm), the softmax, RoPE, the norms and the
# per-use bf16 weight casts.
SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the config's remat policy (counterpart of the
    reference's ``_maybe_remat``, ``transformer.py:39-47``): "none" keeps
    every activation, "full" recomputes the layer in the backward, and
    "selective" recomputes it but for the ``SAVED_OPS`` outputs."""
    if policy == "none":
        return fn
    if policy == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if policy == "selective":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(
                           create_selective_checkpoint_contexts,
                           _selective_policy))
    raise ValueError(policy)


def _runner(cfg: ModelConfig, scoring: bool):
    """-> run(block, *args): the block under the config's remat policy
    when gradients are on and ``scoring`` is off (else there is nothing
    to save)."""
    remat = not scoring and torch.is_grad_enabled()

    def run(block, *args):
        return (_remat(block, cfg.remat_policy) if remat else block)(*args)
    return run


def lm_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
              scoring: bool = False, memory: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None,
              ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, d), compute dtype.
    ``memory`` is the vlm's image embeddings (B, n_img, d) or the encdec's
    frame embeddings (B, T, frontend_dim), which those families need.
    ``segment_ids``/``positions`` (B, S) isolate the documents of packed
    rows (dense and moe only, as in the reference)."""
    if segment_ids is not None and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"sequence packing is attention-mask based; family "
            f"{cfg.family!r} has no segment isolation")
    dt = dtype_of(cfg.compute_dtype)
    if cfg.family in ("vlm", "encdec"):
        if memory is None:
            raise ValueError(MEMORY_NEEDED[cfg.family])
        memory = memory.to(dt)
    check_mesh(cfg, ctx)
    x = embed_tokens(params["embed"], tokens, dt, ctx)
    run = _runner(cfg, scoring)

    lax, sax = block_axes(cfg, ctx)
    if cfg.family in ("dense", "moe"):
        for p in _unstack(params["layers"], cfg.num_layers):
            x = run(_dense_block, cfg, p, x, scoring, positions, segment_ids,
                    True, ctx, lax)
    elif cfg.family == "ssm":
        for p in _unstack(params["layers"], cfg.num_layers):
            x = run(_mamba_block, cfg, p, x, ctx, lax)
    elif cfg.family == "hybrid":
        # each site's Mamba2 layers, then the shared block (the dense
        # rules, its own axes)
        ns, k = n_sites(cfg)
        scfg = shared_cfg(cfg)
        for site in _unstack(params["layers"], ns):
            for p in _unstack(site, k):
                x = run(_mamba_block, cfg, p, x, ctx, lax)
            x = run(_dense_block, scfg, params["shared"], x, scoring, None,
                    None, True, ctx, sax)
    elif cfg.family == "vlm":
        # each site's self-attention layers, then its cross block
        ns, k = n_sites(cfg)
        for site, cp in zip(_unstack(params["layers"], ns),
                            _unstack(params["cross"], ns)):
            for p in _unstack(site, k):
                x = run(_dense_block, cfg, p, x, scoring)
            x = run(_cross_block, cfg, cp, x, memory)
    elif cfg.family == "encdec":
        enc = encode(cfg, params, memory, scoring=scoring)
        L = cfg.num_layers
        for p, cp in zip(_unstack(params["layers"], L),
                         _unstack(params["cross"], L)):
            x = run(_decoder_block, cfg, p, cp, x, enc, scoring)
    else:
        raise ValueError(cfg.family)
    return final_norm(cfg, params, x, ctx)


def final_norm(cfg: ModelConfig, params: Dict, x: torch.Tensor,
               ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    fn = params.get("final_norm")
    if fn is not None and ctx.mesh is not None:
        fn = ctx.gather_params(fn, param_axes(cfg)["final_norm"])
    return apply_norm(cfg.norm_kind, x, fn)


# the reference's reasons (its lm_hidden asserts them)
MEMORY_NEEDED = {"vlm": "vlm needs image embeddings",
                 "encdec": "encdec needs frame embeddings"}


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor, *,
           scoring: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings (B, T, frontend_dim) -> (B, T, d),
    compute dtype: ``frontend_proj``, then num_encoder_layers dense blocks
    with bidirectional self-attention (RoPE, no mask; the flash kernel
    without the causal mask when ``scoring``), then ``enc_final_norm``."""
    dt = dtype_of(cfg.compute_dtype)
    x = frames.to(dt) @ params["frontend_proj"].to(dt)
    run = _runner(cfg, scoring)
    for p in _unstack(params["encoder"], cfg.num_encoder_layers):
        x = run(_dense_block, cfg, p, x, scoring, None, None, False)
    return apply_norm(cfg.norm_kind, x, params.get("enc_final_norm"))


def memory_of(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """The batch's memory: ``frames`` for encdec, else ``image_embeds``
    (None for the families without one)."""
    return batch.get("frames") if cfg.is_encdec \
        else batch.get("image_embeds")


def lm_per_sample_loss(cfg: ModelConfig, params: Dict,
                       batch: Dict[str, torch.Tensor], *,
                       scoring: bool = False, seq_chunk: int = 1024,
                       ctx: ShardCtx = ShardCtx()
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (per_sample_loss (B,) f32, mean ()).

    ``scoring=True`` is the no-grad ES scoring forward through the
    flash-attention and fused cross-entropy kernels; call it under
    ``torch.no_grad()``. ``seq_chunk`` chunks the training path's
    cross-entropy (``ESConfig.seq_chunk``); the kernel ignores it.
    """
    h = lm_hidden(cfg, params, batch["tokens"], scoring=scoring,
                  memory=memory_of(cfg, batch),
                  positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"), ctx=ctx)
    if scoring:
        table = unembed_table(params["embed"], ctx).to(h.dtype).contiguous()
        return per_sample_xent_fused(h, table, batch["labels"], ctx=ctx)
    return per_sample_xent(h, unembed_matrix(params["embed"], ctx),
                           batch["labels"], seq_chunk=seq_chunk, ctx=ctx)


def lm_per_segment_loss(cfg: ModelConfig, params: Dict,
                        batch: Dict[str, torch.Tensor], *,
                        seq_chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document losses of a packed batch -> ``(per_seg (B, M), counts
    (B, M))``, M = ``batch["doc_ids"].shape[1]``: the mean NLL over each
    document's live tokens and their count (0 for an empty or pruned
    slot, whose per_seg is 0). Differentiable (training path)."""
    h = lm_hidden(cfg, params, batch["tokens"],
                  positions=batch["positions"],
                  segment_ids=batch["segment_ids"])
    return per_segment_xent(h, unembed_matrix(params["embed"]),
                            batch["labels"], batch["segment_ids"],
                            max_segments=batch["doc_ids"].shape[1],
                            seq_chunk=seq_chunk)
