"""Carry parameters and score-store state across from the JAX package.

``params_from_jax`` converts the pytree of ``repro/models/transformer.py:
init_lm`` (:204-257), given as numpy arrays (``jax.device_get`` of it, or
``np.asarray`` of each leaf), into the port's parameter dict: the same
nested keys, stacked ``layers/*`` with the leading L axis, and the
``(d_in, d_out)`` layout of ``x @ W`` kept as it is. ``embed/tok`` is the
(V, d) table; ``embed/head`` (d, V) is present only for an untied head
(``repro/models/layers.py:210-228``); with tying the head is ``tok.T``.

``scores_from_jax`` converts the JAX ``ESScores`` or ``QuantizedScores``
(``repro/core/scores.py``) into the port's dataclass of the same fields.

This module imports no JAX: the caller hands it numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.scores import ESScores, QuantizedScores

_DENSE_LAYER_KEYS = {"attn", "mlp", "ln1", "ln2"}
_QUANT_FIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
                 "err_seq", "err_s", "err_w")
_F32_FIELDS = ("s", "w", "seen")


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX ``init_lm`` pytree (numpy leaves) -> the port's parameter dict.

    Raises ``ValueError`` for a tree that is not a dense decoder's.
    """
    embed = tree.get("embed")
    if not isinstance(embed, dict) or "tok" not in embed:
        raise ValueError("params_from_jax: missing embed/tok")
    extra = set(embed) - {"tok", "head"}
    if extra:
        raise ValueError(f"params_from_jax: unexpected embed keys {extra}")
    layers = tree.get("layers")
    if not isinstance(layers, dict) or not {"attn", "mlp"} <= set(layers) \
            or set(layers) - _DENSE_LAYER_KEYS:
        raise ValueError("params_from_jax: layers must hold attn, mlp and "
                         "optional ln1/ln2 (family 'dense')")
    extra = set(tree) - {"embed", "layers", "final_norm"}
    if extra:
        raise ValueError(f"params_from_jax: keys of another family {extra}")
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
