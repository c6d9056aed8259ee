"""Carry parameters and score-store state across from the JAX package.

``params_from_jax`` converts the pytree of ``repro/models/transformer.py:
init_lm`` (:204-257), given as numpy arrays (``jax.device_get`` of it, or
``np.asarray`` of each leaf), into the port's parameter dict: the same
nested keys, stacked ``layers/*`` with the leading L axis (the hybrid's
with (n_sites, every), beside its unstacked ``shared`` block), and the
``(d_in, d_out)`` layout of ``x @ W`` kept as it is. ``embed/tok`` is the
(V, d) table; ``embed/head`` (d, V) is present only for an untied head
(``repro/models/layers.py:210-228``); with tying the head is ``tok.T``.
The dense, moe, ssm and hybrid trees convert; vlm and encdec keys raise.
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


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX ``init_lm`` pytree (numpy leaves) -> the port's parameter dict.

    Raises ``ValueError`` for a tree of no ported family: the layers must
    be attention blocks (dense, moe) or Mamba2 blocks (ssm), or Mamba2
    blocks with one ``shared`` attention block (hybrid).
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
    extra = set(tree) - {"embed", "layers", "final_norm", "shared"}
    if extra:
        raise ValueError(f"params_from_jax: keys of a family not ported "
                         f"yet {extra}")
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
