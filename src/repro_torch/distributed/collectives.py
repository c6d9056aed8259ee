"""Collectives over a process group, with their transport and their count
(the communication of ``models/layers.py:ShardCtx``).

Each function takes a local tensor and the group of one mesh axis (or of
several flattened into one), and returns a new tensor:

  all_reduce      sum (or max) over the group, the input's shape;
  all_gather      the group's tensors concatenated along ``dim`` in group
                  rank order;
  reduce_scatter  the sum over the group, cut along ``dim``: this rank's
                  piece;
  all_to_all      ``dim`` cut in n pieces, piece j sent to rank j, the
                  received pieces concatenated along ``dim``.

Transport, by the tensor's device and the group's backend:

* ``meta`` (the dry run's trace): an empty result of the collective's
  shape, as a kernel's ``meta`` route returns one; the fake group of the
  trace would move no data either;
* CPU: the c10d calls of the group (gloo);
* CUDA on a gloo group (several processes sharing one card, which NCCL
  refuses): staged through pinned host buffers, the collective run on
  them, the result copied back to the card. ``STAGED`` counts the bytes
  each kind copied in and out, ``SECONDS`` the host time each kind took
  (the copies' device syncs included);
* CUDA on any other backend (NCCL): the c10d calls on the card.

gloo has no reduce-scatter and no all-to-all of one tensor everywhere:
those two run as an all-reduce (resp. all-gather) and a slice. That is
transport only: what each collective reports is its own result.

Count: each call tells the listening cost counters (``kernels/_cost.py``,
``launch/cost.py:CostCounter.collective``) its kind, its result buffer's
bytes (the reference's ``hlo_analysis.collective_bytes`` rule: the
per-device result of the op) and the mesh axes it runs over, on the card
and on ``meta`` alike. Work done to move the data (the staging copies,
the c10d calls) is hidden from the counters (``_cost.quiet``), so a trace
and the card's run count the same collectives.
"""
from __future__ import annotations

import collections
import time
from typing import Tuple

import torch
import torch.distributed as dist

from ..kernels import _cost

STAGED: collections.Counter = collections.Counter()  # bytes through host
SECONDS: collections.Counter = collections.Counter()  # host clock, a kind


def _report(kind: str, out: torch.Tensor, axes: Tuple[str, ...]) -> None:
    if _cost.SINKS:
        n = out.numel() * out.element_size()
        for sink in _cost.SINKS:
            sink.collective(kind, n, axes)


def _staged(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x: torch.Tensor, kind: str) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    STAGED[kind] += h.numel() * h.element_size()
    return h


def _from_host(h: torch.Tensor, out: torch.Tensor, kind: str) -> None:
    out.copy_(h)
    STAGED[kind] += h.numel() * h.element_size()


def _run(x: torch.Tensor, out: torch.Tensor, group, kind: str, host_fn):
    """Fill ``out`` with ``host_fn(x')``, x' being x on a device the
    group's backend serves (x itself, or its pinned host copy)."""
    t0 = time.perf_counter()
    with _cost.quiet():
        if x.is_cuda and _staged(group):
            _from_host(host_fn(_to_host(x, kind)), out, kind)
        else:
            out.copy_(host_fn(x))
    SECONDS[kind] += time.perf_counter() - t0


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def all_reduce(x: torch.Tensor, group, axes: Tuple[str, ...],
               op: str = "sum") -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not x.is_meta:
        def fn(t):
            t = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, op=_reduce_op(op), group=group)
            return t
        _run(x, out, group, "all-reduce", fn)
    _report("all-reduce", out, axes)
    return out


def _gather_host(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, group, n: int, dim: int,
               axes: Tuple[str, ...]) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= n
    out = x.new_empty(shape)
    if not x.is_meta:
        _run(x, out, group, "all-gather",
             lambda t: _gather_host(t, group, n, dim))
    _report("all-gather", out, axes)
    return out


def reduce_scatter(x: torch.Tensor, group, n: int, rank: int, dim: int,
                   axes: Tuple[str, ...]) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"over {n} ranks")
    piece = x.shape[dim] // n
    shape = list(x.shape)
    shape[dim] = piece
    out = x.new_empty(shape)
    if not x.is_meta:
        def fn(t):
            t = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, group=group)
            return t.narrow(dim, rank * piece, piece)
        _run(x, out, group, "reduce-scatter", fn)
    _report("reduce-scatter", out, axes)
    return out


def all_to_all(x: torch.Tensor, group, n: int, rank: int, dim: int,
               axes: Tuple[str, ...]) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"all_to_all: dim {dim} of {tuple(x.shape)} over "
                         f"{n} ranks")
    piece = x.shape[dim] // n
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not x.is_meta:
        def fn(t):
            full = _gather_host(t, group, n, dim)   # rank j's x at block j
            return torch.cat([full.narrow(dim, (j * n + rank) * piece, piece)
                              for j in range(n)], dim=dim)
        _run(x, out, group, "all-to-all", fn)
    _report("all-to-all", out, axes)
    return out
