"""Logical-axis -> mesh-axis rules, sharding trees, and where the score
store's row blocks live (counterpart of ``repro/distributed/sharding.py``).

Meshes (``launch/mesh.py``): ("data", "model") = (16, 16) single-pod,
("pod", "data", "model") = (2, 16, 16) two-pod, or any grid of
``make_mesh_for``. Logical axes, as the reference's:

  batch       activation batch dim          -> every data axis
  heads/mlp   attention heads, FFN hidden   -> "model"
  kv_heads    KV heads                      -> "model", or replicated when
              ``shard_kv_heads`` is off or they do not divide the axis
  vocab       embedding / unembedding rows  -> "model"
  embed       a parameter's d_model dim     -> the data axes under FSDP
              (``fsdp_params``), else replicated
  expert      MoE expert count              -> "model" under EP (when the
              experts cover it; else TP, with the reference's warning)
  moe_mlp     an expert's FFN hidden width  -> "model" under TP
  expert_cap  MoE dispatch capacity         -> the data axes for TP with
              ``moe_groups`` 1 (global dispatch)
  expert_group MoE dispatch group           -> the data axes unless
              ``moe_groups`` is 1 (``models/moe.py`` places the work)
  cache_seq   KV-cache sequence dim         -> "model" when decoding with
              replicated KV heads; the data axes at ``long_500k``
  scores      the score store's rows        -> the data axes
  layers      the stacked layer dim         -> never split

A sharding here is each dimension's mesh axis (None, a name or a tuple
of names): the reference's ``PartitionSpec`` as a tuple. ``shard_tree``
cuts a global tree into this rank's pieces, which is how a rank takes
its part of parameters made whole (``bridge.params_from_jax``, a
checkpoint). The rules shard evenly (``check_even``), so every rank's
pieces have the same shapes.

The store's placement is a plain list of devices, one row block each
(``core.scores.ScoreSharding``). ``local_devices`` is the one place that
says which devices a run has: the trainer's ``--shard-scores`` and
``fault_tolerance.elastic_restart`` take their list from it, and a caller
that wants several blocks on fewer devices (the CPU tests, the card's
smoke run) replaces it.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.layers import ShardCtx


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _mesh_size(mesh, name: str, default: int = 1) -> int:
    names = list(mesh.mesh_dim_names)
    return int(mesh.size(names.index(name))) if name in names else default


def make_rules(cfg: ModelConfig, mesh,
               kind: str = "train") -> Tuple[Tuple[str, Any], ...]:
    """kind: train | prefill | decode | long (the reference's rules)."""
    dp = dp_axes(mesh)
    model_size = _mesh_size(mesh, "model")
    ep = cfg.moe_sharding == "ep" and cfg.num_experts >= model_size
    if cfg.moe_sharding == "ep" and cfg.num_experts and not ep:
        warnings.warn(
            f"{cfg.name}: moe_sharding='ep' but {cfg.num_experts} experts "
            f"< {model_size}-way model axis — falling back to TP-sharded "
            "experts (d_ff over 'model'). See EXPERIMENTS.md §Perf cell 2.",
            stacklevel=2)

    shard_kv = cfg.shard_kv_heads and cfg.num_kv_heads % max(model_size, 1) == 0
    if kind == "long":
        batch_rule = None            # batch = 1: nothing to shard
        cache_seq = dp               # 500k cache sequence over DP axes
    elif kind == "decode":
        batch_rule = dp
        cache_seq = None if shard_kv else "model"
    else:
        batch_rule = dp
        cache_seq = None

    return (
        ("batch", batch_rule),
        ("heads", "model"),
        ("mlp", "model"),
        ("kv_heads", "model" if shard_kv else None),
        ("vocab", "model"),
        ("embed", dp if cfg.fsdp_params else None),
        ("expert", "model" if ep else None),
        ("moe_mlp", None if ep else "model"),
        ("expert_cap", None if (ep or cfg.moe_groups != 1) else dp),
        ("expert_group", dp if cfg.moe_groups != 1 else None),
        ("cache_seq", cache_seq),
        ("scores", dp),
        ("layers", None),
    )


def make_ctx(cfg: ModelConfig, mesh, kind: str = "train",
             rule_overrides: Optional[Dict[str, Any]] = None) -> ShardCtx:
    if mesh is None:
        return ShardCtx()
    rules = make_rules(cfg, mesh, kind)
    if rule_overrides:
        rules = tuple((k, rule_overrides.get(k, v)) for k, v in rules)
        extra = tuple((k, v) for k, v in rule_overrides.items()
                      if k not in dict(rules))
        rules = rules + extra
    return ShardCtx(mesh=mesh, rules=rules)


def _is_axes(x) -> bool:
    return x is None or isinstance(x, tuple)


def _map_axes(fn, axes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree)
    return {k: _map_axes(fn, v) for k, v in axes_tree.items()}


def axes_to_sharding(axes_tree, ctx: ShardCtx):
    """Each leaf's logical axes -> its per-dimension mesh axes (the
    reference's ``NamedSharding`` spec, as a tuple; () replicated)."""
    return _map_axes(lambda ax: ctx.spec(ax) if ax is not None else (),
                     axes_tree)


def replicated(ctx: ShardCtx) -> tuple:
    return ()


def batch_sharding(ctx: ShardCtx, ndim: int, batch_dim: int = 0) -> tuple:
    spec: list = [None] * ndim
    spec[batch_dim] = "batch"
    return ctx.spec(spec)


def shard_tree(tree, axes_tree, ctx: ShardCtx):
    """This rank's piece of each leaf of a global ``tree`` (tensors or
    numpy arrays, nested dicts) with logical ``axes_tree``: each
    dimension cut to the rank's slice along its axis. Tensors stay
    views; numpy arrays become tensors."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes_tree[k], ctx) for k, v in tree.items()}
    t = torch.as_tensor(np.asarray(tree)) if not isinstance(
        tree, torch.Tensor) else tree
    for dim, a in enumerate(axes_tree or ()):
        lo, n = ctx.local(a, t.shape[dim])
        t = t.narrow(dim, lo, n)
    return t


def check_even(shapes, axes_tree, ctx: ShardCtx) -> Optional[str]:
    """Why a tree of ``shapes`` does not split evenly under ``ctx``, or
    None: every rank then holds pieces of the same shapes, which is what
    lets one rank's trace stand for every device."""
    bad: List[str] = []

    def walk(s, a, path):
        if isinstance(s, dict):
            for k in s:
                walk(s[k], a[k], f"{path}/{k}")
            return
        for n, ax in zip(s, a or ()):
            m = ctx.size(ax)
            if n % m:
                bad.append(f"{path}: {n} over {m} ({ax})")
    walk(shapes, axes_tree, "")
    return "; ".join(bad) or None


def local_devices(device) -> List[torch.device]:
    """The devices of this process for a run on ``device``: every CUDA
    device for a CUDA run, the one CPU for a CPU run."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def score_store_sharding(devices: Sequence) -> Optional["ScoreSharding"]:
    """One row block per entry of ``devices`` (repeats allowed), or None
    when that gives fewer than two blocks (the store stays replicated)."""
    from ..core.scores import ScoreSharding
    if len(devices) < 2:
        return None
    return ScoreSharding(tuple(devices))
