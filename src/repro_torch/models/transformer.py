"""Decoder LMs of the dense, MoE, SSM and hybrid families: init, hidden
states, per-sample and per-segment loss (counterpart of
``repro/models/transformer.py``: the blocks :80-166, ``init_lm`` :204,
``lm_hidden`` :270, ``lm_per_sample_loss`` :378, ``lm_per_segment_loss``
:397).

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

Two forwards compute the same per-sample loss:

* ``scoring=False``: the training path in plain autograd, as the
  reference's XLA path, with its three memory knobs: each block under the
  config's ``remat_policy`` (when gradients are on), query chunks of
  ``attn_chunk_q`` in the attention, and sequence chunks of ``seq_chunk``
  in the cross-entropy;
* ``scoring=True``: the no-grad ES scoring forward, with every causal
  self-attention through the flash-attention kernel and the loss through
  the fused cross-entropy kernel, which reads the (V, d) embedding table
  without a transpose. The MoE dispatch and the Mamba2 blocks are plain
  PyTorch on both paths, as they are XLA in the reference.

Packed rows (``positions`` and ``segment_ids``) take the training path
with segment-isolated attention (dense and moe only: the SSM recurrences
have no segment reset); ``lm_per_segment_loss`` is the packed step's one
differentiated forward.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import dataclasses

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig, require_ported
from ..kernels.xent.ops import per_sample_xent_fused
from .attention import init_attn, mha
from .layers import (Params, apply_norm, embed_tokens, init_embedding,
                     init_mlp, init_norm, mlp_fwd, unembed_matrix,
                     unembed_table)
from .losses import per_sample_xent, per_segment_xent
from .moe import init_moe, moe_fwd
from .ssm import init_mamba2, mamba2_fwd


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _init_dense_block(cfg: ModelConfig, lead: Tuple[int, ...], device,
                      gen: torch.Generator) -> Dict:
    """Attention + MLP (or MoE, with arctic's dense residual) block."""
    d = cfg.d_model
    p: Dict = {"attn": init_attn(d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim(), cfg.qkv_bias,
                                 lead, device, gen)}
    ln1 = init_norm(cfg.norm_kind, d, lead, device)
    if ln1 is not None:
        p["ln1"] = ln1
        p["ln2"] = init_norm(cfg.norm_kind, d, lead, device)
    if cfg.num_experts > 0:
        p["moe"] = init_moe(d, cfg.d_ff, cfg.num_experts, lead, device, gen)
        if cfg.moe_dense_residual:
            p["dense_res"] = init_mlp("swiglu", d, cfg.dense_residual_d_ff,
                                      lead, device, gen)
    else:
        p["mlp"] = init_mlp(cfg.mlp_kind, d, cfg.d_ff, lead, device, gen)
    return p


def _init_mamba_block(cfg: ModelConfig, lead: Tuple[int, ...], device,
                      gen: torch.Generator) -> Dict:
    p: Dict = {}
    ln1 = init_norm(cfg.norm_kind, cfg.d_model, lead, device)
    if ln1 is not None:
        p["ln1"] = ln1
    p["mamba"] = init_mamba2(cfg.d_model, state=cfg.ssm_state,
                             head_dim=cfg.ssm_head_dim,
                             expand=cfg.ssm_expand,
                             conv_width=cfg.ssm_conv_width, lead=lead,
                             device=device, gen=gen)
    return p


def n_sites(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_sites, layers a site) of the hybrid's grouped stack."""
    every = cfg.hybrid_attn_every
    assert every > 0 and cfg.num_layers % every == 0, (cfg.num_layers, every)
    return cfg.num_layers // every, every


def shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared block: dense attention + MLP at d_model width
    (the reference's ``dataclasses_replace_dense``)."""
    return dataclasses.replace(cfg, family="dense", num_experts=0)


def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """Random parameters with the reference's distributions: N(0, 0.02^2)
    weights (the SSM convolutions 0.1^2), zero biases, unit norm scales,
    ``A_log`` = log(1..nh), all float32 (``param_dtype`` applied last).
    Drawn from ``gen`` on ``device``; the draws differ from JAX's (tests
    carry JAX parameters across with ``bridge``)."""
    require_ported(cfg)
    d = cfg.d_model
    params: Dict = {"embed": init_embedding(cfg.vocab_size, d,
                                            cfg.tie_embeddings, device, gen)}
    fn = init_norm(cfg.norm_kind, d, (), device)
    if fn is not None:
        params["final_norm"] = fn
    if cfg.family in ("dense", "moe"):
        params["layers"] = _init_dense_block(cfg, (cfg.num_layers,), device,
                                             gen)
    elif cfg.family == "ssm":
        params["layers"] = _init_mamba_block(cfg, (cfg.num_layers,), device,
                                             gen)
    else:  # hybrid
        params["layers"] = _init_mamba_block(cfg, n_sites(cfg), device, gen)
        params["shared"] = _init_dense_block(shared_cfg(cfg), (), device,
                                             gen)
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


def ffn(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward: MoE (+ the dense residual) or the MLP."""
    if cfg.num_experts > 0:
        y = moe_fwd(p["moe"], h, n_experts=cfg.num_experts,
                    top_k=cfg.num_experts_per_tok,
                    capacity_factor=cfg.capacity_factor,
                    n_groups=cfg.moe_groups)
        if cfg.moe_dense_residual:
            y = y + mlp_fwd("swiglu", p["dense_res"], h)
        return y
    return mlp_fwd(cfg.mlp_kind, p["mlp"], h)


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scoring: bool, positions: Optional[torch.Tensor],
                 segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    x = x + mha(p["attn"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta,
                chunk_q=cfg.attn_chunk_q, scoring=scoring,
                positions=positions, segment_ids=segment_ids)
    h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    return x + ffn(cfg, p, h)


def _mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scoring: bool, positions: Optional[torch.Tensor],
                 segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """A Mamba2 block (no attention: ``scoring`` and the packing
    arguments are the dense block's signature, unused)."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    return x + mamba2_fwd(p["mamba"], h, state=cfg.ssm_state,
                          head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                          chunk=cfg.ssm_chunk)


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


def lm_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
              scoring: bool = False, positions: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, d), compute dtype.
    ``segment_ids``/``positions`` (B, S) isolate the documents of packed
    rows (dense and moe only, as in the reference)."""
    require_ported(cfg)
    if segment_ids is not None and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"sequence packing is attention-mask based; family "
            f"{cfg.family!r} has no segment isolation")
    x = embed_tokens(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    remat = not scoring and torch.is_grad_enabled()   # else nothing to save

    def run(block, bcfg, p, h):
        fn = _remat(block, cfg.remat_policy) if remat else block
        return fn(bcfg, p, h, scoring, positions, segment_ids)

    if cfg.family in ("dense", "moe"):
        for p in _unstack(params["layers"], cfg.num_layers):
            x = run(_dense_block, cfg, p, x)
    elif cfg.family == "ssm":
        for p in _unstack(params["layers"], cfg.num_layers):
            x = run(_mamba_block, cfg, p, x)
    else:  # hybrid: each site's Mamba2 layers, then the shared block
        ns, k = n_sites(cfg)
        scfg = shared_cfg(cfg)
        for site in _unstack(params["layers"], ns):
            for p in _unstack(site, k):
                x = run(_mamba_block, cfg, p, x)
            x = run(_dense_block, scfg, params["shared"], x)
    return apply_norm(cfg.norm_kind, x, params.get("final_norm"))


def lm_per_sample_loss(cfg: ModelConfig, params: Dict,
                       batch: Dict[str, torch.Tensor], *,
                       scoring: bool = False, seq_chunk: int = 1024
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (per_sample_loss (B,) f32, mean ()).

    ``scoring=True`` is the no-grad ES scoring forward through the
    flash-attention and fused cross-entropy kernels; call it under
    ``torch.no_grad()``. ``seq_chunk`` chunks the training path's
    cross-entropy (``ESConfig.seq_chunk``); the kernel ignores it.
    """
    h = lm_hidden(cfg, params, batch["tokens"], scoring=scoring,
                  positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"))
    if scoring:
        table = unembed_table(params["embed"]).to(h.dtype).contiguous()
        return per_sample_xent_fused(h, table, batch["labels"])
    return per_sample_xent(h, unembed_matrix(params["embed"]),
                           batch["labels"], seq_chunk=seq_chunk)


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
