"""The dry run's cost counter: FLOPs, bytes, peak memory and roofline terms
of one traced step, per card (counterpart of ``repro/launch/hlo_cost.py``
and ``hlo_analysis.py``).

``CostCounter`` is a ``TorchDispatchMode`` over one step. It sees each
aten op the step runs, after autograd and after PyTorch's composite ops
are split into their parts, on ``meta`` tensors (the dry run: shapes
only, nothing allocated or launched) or on CUDA ones (the same count over
the card's real step). Ops whose tensors all lie on the CPU are left out.
It counts:

  flops : 2 x result elements x contraction for every dot-family op
          (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``,
          ``dot``: what ``matmul``, ``einsum`` and ``linear`` lower to),
          the reference's rule (``hlo_cost.py:_dot_flops``): elementwise
          ops and convolutions are not counted. Kept by dtype, so that
          the compute term divides each dtype's share by its peak.
  bytes : the operand and result bytes of every op that is not a view
          or an allocation, each tensor's distinct elements once (an
          expanded dimension counts once). This differs on purpose from
          the reference, which leaves out ops that XLA fuses into their
          neighbours (``hlo_cost.py:_FUSABLE_OPS``): eager PyTorch fuses
          nothing, so each elementwise pass really crosses memory. A
          gather counts what it reads and writes, not its whole table;
          an indexed or whole write (``index_copy_``, ``copy_``) counts
          its source and the region written, not the destination's old
          contents.
  peak  : the high-water mark of the bytes of the storages that ops of
          the step create and that are still alive, over the step; the
          arguments (parameters, optimizer state, store, batch, cache)
          are summed from their shapes by ``tree_bytes``.

Each hand-written kernel reports its own work through
``kernels/_cost.py``, on the card and on ``meta`` alike: flash counts
4 B H S^2 hd bfloat16 FLOPs (the full square, as the reference's XLA
attention dots), xent's partials 2 M V d; bytes are each kernel's inputs
read once and outputs written once.

Collectives (``distributed/collectives.py``) report themselves, as the
kernels do: each one's kind and result buffer's bytes per device, the
reference's ``hlo_analysis.collective_bytes`` rule, and the mesh axes it
runs over. The work that moves their data is not counted (``_cost.quiet``).

``roofline_terms`` keeps the reference's keys, for one H100 SXM: 989
TFLOP/s bfloat16 (float16 alike), 67 TFLOP/s float32 (TF32 is off for
matmuls in PyTorch), 3.35 TB/s of HBM. ``collective_s`` is each axis's
collective bytes over its link rate, summed: the mesh laid out with
"model" innermost on 8-GPU HGX H100 nodes, an axis whose span (its size
times the sizes of the axes inside it) is at most 8 GPUs stays inside a
node on NVLink 4 (``NVLINK_BW``), a wider one crosses nodes over NDR
InfiniBand (``IB_BW``). Both rates are published specifications, not
measurements.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _cost

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12, torch.float64: 67e12}
HBM_BW = 3.35e12          # bytes/s
CARD_BYTES = 80 * 10**9   # one H100's device memory
# link rates a direction a GPU (specifications): NVLink 4 inside an
# 8-GPU HGX H100 node (NVIDIA's HGX H100 data sheet: 900 GB/s both
# directions), and one 400 Gb/s NDR InfiniBand adapter a GPU between nodes
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_GPUS = 8
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.mv, aten.addmv,
         aten.dot}
# allocations, aliases and host reads: no memory traffic of their own
# (the views are ``func.is_view``)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten._unsafe_view, aten._local_scalar_dense, aten.record_stream}
# read the gathered elements only
_GATHERS = {aten.index, aten.index_select, aten.gather}
# write their values into a region of their first argument, in place
_WRITES = {aten.index_copy_, aten.index_put_}
# overwrite their first argument whole without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def _tensors(*groups) -> list:
    """The tensors among ``groups`` of an op's arguments or results, and
    inside their lists and tuples (an aten op nests no deeper)."""
    out = []
    for group in groups:
        for x in group:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (an expanded dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _state_tensors(obj) -> Iterable[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _state_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _state_tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _state_tensors(getattr(obj, f.name))


def tree_bytes(*trees) -> int:
    """Bytes of the storages behind every tensor of ``trees`` (dicts,
    lists, tuples, dataclasses), each storage once (a tied or viewed leaf
    is not counted twice)."""
    seen: Dict[int, int] = {}
    for t in _state_tensors(trees):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class CostCounter(TorchDispatchMode):
    """Counts one step's work while active (``with CostCounter() as c``):
    ``flops`` by dtype, ``bytes``, ``peak`` of the step's own storages,
    ``launches`` of each kernel and ``ops`` of each dot-family op."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[torch.dtype, float] = collections.defaultdict(float)
        self.bytes = 0
        self.launches: collections.Counter = collections.Counter()
        self.ops: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}
        self.collectives = {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVE_KINDS}
        self.collective_axes: collections.Counter = collections.Counter()

    def __enter__(self):
        _cost.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.SINKS.remove(self)
        return super().__exit__(*exc)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def kernel(self, name: str, flops: float, dtype: torch.dtype,
               n_bytes: int) -> None:
        """A kernel launch's own report (``kernels/_cost.py``)."""
        self.launches[name] += 1
        if flops:
            self.flops[dtype] += flops
        self.bytes += n_bytes

    def collective(self, kind: str, n_bytes: int, axes) -> None:
        """A collective's own report (``distributed/collectives.py``)."""
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += n_bytes
        self.collective_axes[tuple(axes)] += n_bytes

    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())

    def _track(self, ins: Iterable[torch.Tensor],
               outs: Iterable[torch.Tensor]) -> None:
        """Add each output storage that no input holds and that is not
        tracked yet; it leaves the live sum when it is freed."""
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._alive:
                continue
            n = st.nbytes()
            self._alive[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _cost.QUIET[0]:
            return out
        ins = _tensors(args, kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if all(t.device.type == "cpu" for t in ins + outs):
            return out
        self._track(ins, outs)
        packet = func.overloadpacket
        if packet in _DOTS:
            self.ops[packet.__name__] += 1
            self.flops[outs[0].dtype] += _dot_flops(packet, args, outs[0])
        self.bytes += _op_bytes(func, packet, args, ins, outs)
        return out


def _dot_flops(packet, args, out: torch.Tensor) -> float:
    """2 x result elements x contraction length."""
    if packet in (aten.addmm, aten.baddbmm, aten.addmv):
        lhs = args[1]
    else:
        lhs = args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _op_bytes(func, packet, args, ins, outs) -> int:
    if packet in _FREE or func.is_view:
        return 0
    if packet in _GATHERS:
        index = [t for t in ins[1:] if not t.is_floating_point()]
        return (2 * sum(tensor_bytes(t) for t in outs)
                + sum(tensor_bytes(t) for t in index))
    if packet in _WRITES:
        src = ins[1:]   # indices and values; the region written is the
        #                 values' size
        vals = [t for t in src if t.dtype == ins[0].dtype]
        return (sum(tensor_bytes(t) for t in src)
                + sum(tensor_bytes(t) for t in vals))
    if packet in _OVERWRITES:
        return (sum(tensor_bytes(t) for t in ins[1:])
                + sum(tensor_bytes(t) for t in outs))
    return (sum(tensor_bytes(t) for t in ins)
            + sum(tensor_bytes(t) for t in outs))


def link_bw(mesh_info: Dict[str, Any], axes) -> float:
    """The link rate of a collective over mesh ``axes``: NVLink when the
    outermost of them spans at most one node, else InfiniBand."""
    names, shape = mesh_info["axis_names"], mesh_info["shape"]
    outer = min(names.index(a) for a in axes)
    span = 1
    for n in shape[outer:]:
        span *= n
    return NVLINK_BW if span <= NODE_GPUS else IB_BW


def collective_seconds(mesh_info: Dict[str, Any],
                       bytes_by_axes: Dict[tuple, int]) -> float:
    return sum(n / link_bw(mesh_info, axes)
               for axes, n in bytes_by_axes.items() if axes)


def roofline_terms(*, flops_by_dtype: Dict[torch.dtype, float],
                   bytes_per_chip: float,
                   collective_s: float = 0.0) -> Dict[str, Any]:
    """The reference's three terms (seconds) and the dominant one, for
    one H100: compute is each dtype's FLOPs over its peak, summed."""
    compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS[torch.float32])
                  for dt, f in flops_by_dtype.items())
    terms: Dict[str, Any] = {
        "compute_s": compute,
        "memory_s": bytes_per_chip / HBM_BW,
        "collective_s": collective_s,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["step_s_lower_bound"] = total
    if total > 0:
        terms["roofline_fraction"] = terms["compute_s"] / total
    return terms


def summary(counter: CostCounter, args_bytes: int,
            mesh_info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The counter's numbers as the dry run reports them (per device on
    a mesh: one rank's)."""
    peak = args_bytes + counter.peak
    coll_s = (collective_seconds(mesh_info, counter.collective_axes)
              if mesh_info else 0.0)
    return {
        "flops": counter.total_flops,
        "flops_by_dtype": {str(dt).replace("torch.", ""): f
                           for dt, f in sorted(counter.flops.items(),
                                               key=lambda kv: str(kv[0]))},
        "bytes": counter.bytes,
        "dot_ops": dict(counter.ops),
        "kernel_launches": dict(counter.launches),
        "memory": {"argument_bytes": args_bytes,
                   "step_high_water_bytes": counter.peak,
                   "peak_bytes": peak},
        "fits_one_card": peak <= CARD_BYTES,
        "collectives": {k: dict(v) for k, v in counter.collectives.items()
                        if v["count"]},
        "collective_bytes_total": counter.collective_bytes,
        "roofline": roofline_terms(flops_by_dtype=counter.flops,
                                   bytes_per_chip=counter.bytes,
                                   collective_s=coll_s),
    }
