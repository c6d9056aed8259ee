"""Carry parameters and score-store state across from the JAX package.

``params_from_jax`` converts the pytree of ``repro/models/transformer.py:
init_lm`` (:204-257), given as numpy arrays (``jax.device_get`` of it, or
``np.asarray`` of each leaf), into the port's parameter dict: the same
nested keys, stacked ``layers/*`` with the leading L axis (the hybrid's
and the vlm's with (n_sites, every), beside the hybrid's unstacked
``shared`` block or the vlm's ``cross`` blocks), and the ``(d_in,
d_out)`` layout of ``x @ W`` kept as it is. ``embed/tok`` is the (V, d)
table; ``embed/head`` (d, V) is present only for an untied head
(``repro/models/layers.py:210-228``); with tying the head is ``tok.T``.
Every family's tree converts: dense, moe, ssm, hybrid, vlm (``cross``:
gated cross-attention blocks) and encdec (``cross`` = {attn, ln},
``encoder``, ``frontend_proj``, ``enc_final_norm``); keys of no family
raise.
A bfloat16 leaf (``ml_dtypes.bfloat16`` in numpy, e.g. arctic's
``param_dtype``), which ``torch.from_numpy`` refuses, goes through
float32 (exact) and becomes ``torch.bfloat16``.

``scores_from_jax`` converts the JAX ``ESScores`` or ``QuantizedScores``
(``repro/core/scores.py``) into the port's dataclass of the same fields.

This module imports no JAX: the caller hands it numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.scores import ESScores, QuantizedScores

# a block of attention + MLP (dense) or + MoE [+ dense residual] (moe)
_ATTN_BLOCK_KEYS = {"attn", "mlp", "moe", "dense_res", "ln1", "ln2"}
_MAMBA_BLOCK_KEYS = {"mamba", "ln1"}
_GATED_CROSS_KEYS = {"attn", "mlp", "gate_attn", "gate_mlp", "ln1", "ln2"}
_ENCDEC_KEYS = {"encoder", "frontend_proj", "enc_final_norm"}
_QUANT_FIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
                 "err_seq", "err_s", "err_w")
_F32_FIELDS = ("s", "w", "seen")


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _attn_block(block: Any) -> bool:
    """An attention block: attn, one feed-forward (mlp or moe), and only
    the keys such a block has."""
    return isinstance(block, dict) and "attn" in block \
        and ("mlp" in block) != ("moe" in block) \
        and not set(block) - _ATTN_BLOCK_KEYS \
        and ("dense_res" not in block or "moe" in block)


def _cross_tree(tree: Dict[str, Any]) -> bool:
    """A ``cross`` entry of the vlm (gated cross blocks) or of the encdec
    (cross-attention and its norm, beside an encoder)."""
    cross = tree["cross"]
    if not isinstance(cross, dict) or "attn" not in cross:
        return False
    if "encoder" in tree:
        return not set(cross) - {"attn", "ln"}
    return not set(cross) - _GATED_CROSS_KEYS \
        and {"mlp", "gate_attn", "gate_mlp"} <= set(cross)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX ``init_lm`` pytree (numpy leaves) -> the port's parameter dict.

    Raises ``ValueError`` for a tree of no family: the layers must be
    attention blocks (dense, moe; vlm with gated ``cross`` blocks; encdec
    with an attention-block ``encoder``, ``frontend_proj`` and
    ``cross`` = {attn, ln}) or Mamba2 blocks (ssm), or Mamba2 blocks with
    one ``shared`` attention block (hybrid).
    """
    embed = tree.get("embed")
    if not isinstance(embed, dict) or "tok" not in embed:
        raise ValueError("params_from_jax: missing embed/tok")
    extra = set(embed) - {"tok", "head"}
    if extra:
        raise ValueError(f"params_from_jax: unexpected embed keys {extra}")
    layers = tree.get("layers")
    mamba = isinstance(layers, dict) and "mamba" in layers \
        and not set(layers) - _MAMBA_BLOCK_KEYS
    if not (mamba or _attn_block(layers)):
        raise ValueError("params_from_jax: layers must hold attn with mlp "
                         "or moe (families 'dense', 'moe') or mamba "
                         "(families 'ssm', 'hybrid'), and optional norms")
    if "shared" in tree and not (mamba and _attn_block(tree["shared"])):
        raise ValueError("params_from_jax: a shared block goes with mamba "
                         "layers and is an attention block (family "
                         "'hybrid')")
    if "cross" in tree and not (_attn_block(layers) and _cross_tree(tree)):
        raise ValueError("params_from_jax: cross blocks go with attention "
                         "layers: gated blocks (family 'vlm') or attn and "
                         "ln beside an encoder (family 'encdec')")
    if "encoder" in tree and not ("cross" in tree and "frontend_proj" in tree
                                  and _attn_block(tree["encoder"])):
        raise ValueError("params_from_jax: an encoder is a stack of "
                         "attention blocks with frontend_proj and cross "
                         "(family 'encdec')")
    extra = set(tree) - {"embed", "layers", "final_norm", "shared", "cross"}
    if "encoder" in tree:
        extra -= _ENCDEC_KEYS
    if extra:
        raise ValueError(f"params_from_jax: keys of no family {extra}")
    tok = np.asarray(embed["tok"])
    if "head" in embed and np.asarray(embed["head"]).shape != tok.shape[::-1]:
        raise ValueError("params_from_jax: embed/head must be (d, V)")
    return _convert(tree, device)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter dict -> the same tree of float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def scores_from_jax(scores: Any, device="cpu"):
    """JAX ``ESScores`` or ``QuantizedScores`` with numpy leaves
    (``jax.device_get`` of either) -> the port's ``ESScores`` /
    ``QuantizedScores`` on ``device``, leaves copied with their dtypes."""
    def field(name):
        return torch.from_numpy(np.array(getattr(scores, name),
                                         copy=True)).to(device)

    if hasattr(scores, "s_q"):
        return QuantizedScores(**{f: field(f) for f in _QUANT_FIELDS})
    if hasattr(scores, "s"):
        return ESScores(**{f: field(f) for f in _F32_FIELDS})
    raise ValueError("scores_from_jax: neither ESScores nor "
                     "QuantizedScores fields")
