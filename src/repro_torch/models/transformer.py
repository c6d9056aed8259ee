"""Dense decoder LM: init, hidden states, per-sample and per-segment loss
(counterpart of ``repro/models/transformer.py``: ``init_lm`` :204,
``lm_hidden`` :270, ``lm_per_sample_loss`` :378, ``lm_per_segment_loss``
:397, for ``family == "dense"``).

Parameters are a dict mirroring the JAX pytree, with the layer stack
stacked along a leading L axis (``layers/attn/wq`` is (L, d, H*hd)):

    embed/tok (V, d) [, embed/head (d, V)]   final_norm/scale (d,)
    layers/ln1, ln2 /scale (L, d)            layers/attn/wq, wk, wv, wo [, bq, bk, bv]
    layers/mlp/w_gate, w_up (L, d, f), w_down (L, f, d)

Two forwards compute the same per-sample loss:

* ``scoring=False``: the training path in plain autograd, as the
  reference's XLA path, with its three memory knobs: each layer under the
  config's ``remat_policy`` (when gradients are on), query chunks of
  ``attn_chunk_q`` in the attention, and sequence chunks of ``seq_chunk``
  in the cross-entropy;
* ``scoring=True``: the no-grad ES scoring forward, with attention through
  the flash-attention kernel and the loss through the fused cross-entropy
  kernel, which reads the (V, d) embedding table without a transpose.

Packed rows (``positions`` and ``segment_ids``) take the training path
with segment-isolated attention; ``lm_per_segment_loss`` is the packed
step's one differentiated forward.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig, require_dense
from ..kernels.xent.ops import per_sample_xent_fused
from .attention import init_attn, mha
from .layers import (Params, apply_norm, embed_tokens, init_embedding,
                     init_mlp, init_norm, mlp_fwd, unembed_matrix,
                     unembed_table)
from .losses import per_sample_xent, per_segment_xent


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """Random parameters with the reference's distributions: N(0, 0.02^2)
    weights, zero biases, unit norm scales, all float32 (``param_dtype``
    applied last). Drawn from ``gen`` on ``device``; the draws differ from
    JAX's (tests carry JAX parameters across with ``bridge``)."""
    require_dense(cfg)
    L, d = cfg.num_layers, cfg.d_model
    hd = cfg.resolved_head_dim()
    params: Dict = {"embed": init_embedding(cfg.vocab_size, d,
                                            cfg.tie_embeddings, device, gen)}
    fn = init_norm(cfg.norm_kind, d, (), device)
    if fn is not None:
        params["final_norm"] = fn
    layers: Dict = {"attn": init_attn(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                      cfg.qkv_bias, (L,), device, gen),
                    "mlp": init_mlp(cfg.mlp_kind, d, cfg.d_ff, (L,), device,
                                    gen)}
    ln1 = init_norm(cfg.norm_kind, d, (L,), device)
    if ln1 is not None:
        layers["ln1"] = ln1
        layers["ln2"] = init_norm(cfg.norm_kind, d, (L,), device)
    params["layers"] = layers
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


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scoring: bool, positions: Optional[torch.Tensor],
                 segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    x = x + mha(p["attn"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta,
                chunk_q=cfg.attn_chunk_q, scoring=scoring,
                positions=positions, segment_ids=segment_ids)
    h = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    return x + mlp_fwd(cfg.mlp_kind, p["mlp"], h)


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
    rows."""
    require_dense(cfg)
    x = embed_tokens(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    block = _remat(_dense_block, cfg.remat_policy)
    if scoring or not torch.is_grad_enabled():
        block = _dense_block    # nothing to save: no remat
    for p in _unstack(params["layers"], cfg.num_layers):
        x = block(cfg, p, x, scoring, positions, segment_ids)
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
