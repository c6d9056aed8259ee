"""Layer primitives: the sharding context, norms, RoPE, MLPs, embeddings
(counterpart of ``repro/models/layers.py``: ``ShardCtx`` :25-50, the rest
:74-228).

Functions on tensors. Parameters are plain dicts mirroring the JAX pytree;
weights keep the JAX ``(d_in, d_out)`` layout of ``x @ W``. Norms compute in
float32 and cast back, as the reference does. Each ``*_axes`` function
gives the logical axes of its parameters, the reference's ``init_*``
second result.

Model sharding is SPMD by hand: on a mesh every rank holds plain local
tensors (its shard of each parameter, its rows of the batch, its heads
and vocabulary slice) and the model code calls the collectives that XLA's
partitioner inserts for the reference. ``ShardCtx`` maps logical axes to
mesh axes by the reference's rules (``distributed/sharding.py``) and runs
those collectives over a logical axis's process group; with no mesh every
one of them is the identity and the model code takes its unsharded path.
The tensor-parallel pattern is the usual one: a replicated activation
enters a column-parallel product through ``enter`` (identity forward,
all-reduce of the gradient), a row-parallel product leaves through
``psum`` (all-reduce forward, identity gradient), and an FSDP parameter
is all-gathered where it is used (``gather``: its gradient is
reduce-scattered). A result sharded over an axis whose ranks then repeat
the same work is made whole by ``unshard`` (its gradient: the rank's
slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Any]


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

def _axis_dims(axis) -> Tuple[str, ...]:
    """A rule's mesh axis (None, a name or a tuple of names) as a tuple."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh (a ``torch.distributed`` ``DeviceMesh``) and the
    logical -> mesh axis rules. ``mesh=None`` (one device) makes every
    collective the identity and every extent 1."""
    mesh: Any = None
    rules: Tuple[Tuple[str, Any], ...] = ()

    # -- the rules ---------------------------------------------------------
    def axis(self, logical: Optional[str]):
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """Each dimension's mesh axis: the reference's PartitionSpec as a
        tuple, which names a one-dim tuple such as ("data",) by its
        dim."""
        out = []
        for a in logical_axes:
            ax = self.axis(a)
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
        return tuple(out)

    def dims(self, logical: Optional[str]) -> Tuple[str, ...]:
        """The mesh dims a logical axis is split over (mesh order); "*"
        is every mesh dim (the whole mesh)."""
        if self.mesh is None:
            return ()
        if logical == "*":
            return tuple(self.mesh.mesh_dim_names)
        return _axis_dims(self.axis(logical))

    def replicas(self, axes: Sequence[Optional[str]]) -> int:
        """How many ranks hold each shard of a leaf with logical
        ``axes``: the mesh's size over the extents it is split over."""
        split = {d for a in axes for d in self.dims(a)}
        return self.size("*") // math.prod(
            self.mesh.size(self._dim_index(d)) for d in split)

    def size(self, logical: Optional[str]) -> int:
        """The number of shards of a logical axis."""
        return math.prod(self.mesh.size(self._dim_index(d))
                         for d in self.dims(logical))

    def coord(self, logical: Optional[str]) -> int:
        """This rank's shard index along a logical axis (row-major over
        its mesh dims)."""
        c = 0
        where = self.mesh.get_coordinate() if self.dims(logical) else ()
        for d in self.dims(logical):
            i = self._dim_index(d)
            c = c * self.mesh.size(i) + where[i]
        return c

    def local(self, logical: Optional[str], n: int) -> Tuple[int, int]:
        """(offset, length) of this rank's piece of a dimension of n
        along a logical axis; the rules shard evenly or refuse."""
        m = self.size(logical)
        if n % m:
            raise ValueError(f"{logical!r}: {n} does not split evenly over "
                             f"{m} shards")
        return self.coord(logical) * (n // m), n // m

    def _dim_index(self, name: str) -> int:
        return list(self.mesh.mesh_dim_names).index(name)

    def group(self, logical: Optional[str]):
        """The process group of a logical axis's mesh dims; a tuple of
        dims gets one flattened group, built once for the mesh (every
        rank builds every group of the tuple, in the same order, as
        ``new_group`` needs)."""
        dims = self.dims(logical)
        if len(dims) == 1:
            return self.mesh.get_group(dims[0])
        cache = self.mesh.__dict__.setdefault("_repro_groups", {})
        if dims not in cache:
            import torch.distributed as dist
            import numpy as np
            names = list(self.mesh.mesh_dim_names)
            ranks = np.asarray(self.mesh.mesh.tolist())
            keep = [names.index(d) for d in dims]
            rest = [i for i in range(ranks.ndim) if i not in keep]
            flat = ranks.transpose(rest + keep).reshape(
                -1, math.prod(ranks.shape[i] for i in keep))
            me = dist.get_rank()
            for row in flat:
                g = dist.new_group(sorted(int(r) for r in row))
                if me in row:
                    cache[dims] = g
        return cache[dims]

    # -- collectives over a logical axis (no autograd) ---------------------
    def all_reduce(self, x: torch.Tensor, logical: str,
                   op: str = "sum") -> torch.Tensor:
        if self.size(logical) == 1:
            return x
        return collectives.all_reduce(x, self.group(logical),
                                      self.dims(logical), op)

    def all_gather(self, x: torch.Tensor, logical: str,
                   dim: int = 0) -> torch.Tensor:
        n = self.size(logical)
        if n == 1:
            return x
        return collectives.all_gather(x, self.group(logical), n,
                                      dim % x.ndim, self.dims(logical))

    def reduce_scatter(self, x: torch.Tensor, logical: str,
                       dim: int = 0) -> torch.Tensor:
        n = self.size(logical)
        if n == 1:
            return x
        return collectives.reduce_scatter(x, self.group(logical), n,
                                          self.coord(logical), dim % x.ndim,
                                          self.dims(logical))

    def all_to_all(self, x: torch.Tensor, logical: str,
                   dim: int = 0) -> torch.Tensor:
        n = self.size(logical)
        if n == 1:
            return x
        return collectives.all_to_all(x, self.group(logical), n,
                                      self.coord(logical), dim % x.ndim,
                                      self.dims(logical))

    # -- the tensor-parallel pattern (autograd) ----------------------------
    def psum(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """All-reduce forward, identity gradient: a row-parallel
        product's partial sums, replicated after."""
        if self.size(logical) == 1:
            return x
        return _Psum.apply(x, self, logical)

    def enter(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """Identity forward, all-reduced gradient: a replicated tensor
        read by each rank's own shard of the work."""
        if self.size(logical) == 1:
            return x
        return _Enter.apply(x, self, logical)

    def gather(self, x: torch.Tensor, logical: str,
               dim: int = 0) -> torch.Tensor:
        """All-gather forward, reduce-scattered gradient (FSDP)."""
        if self.size(logical) == 1:
            return x
        return _Gather.apply(x, self, logical, dim % x.ndim)

    def unshard(self, x: torch.Tensor, logical: str,
                dim: int = 0) -> torch.Tensor:
        """All-gather forward, this rank's slice of the gradient backward:
        a sharded result made whole for work that every rank of the axis
        repeats alike (EP's expert outputs before the combine), whose
        gradient each of those ranks holds whole."""
        if self.size(logical) == 1:
            return x
        return _Unshard.apply(x, self, logical, dim % x.ndim)

    def gather_params(self, params, axes):
        """``params`` with each leaf's "embed" dimension all-gathered
        where FSDP splits it (a nested dict, as ``axes``)."""
        if self.size("embed") == 1:
            return params
        if isinstance(params, dict):
            return {k: self.gather_params(v, axes[k])
                    for k, v in params.items()}
        for i, a in enumerate(axes):
            if a == "embed":
                params = self.gather(params, "embed", i)
        return params


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sctx, logical):
        return sctx.all_reduce(x, logical)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sctx, logical):
        ctx.sctx, ctx.logical = sctx, logical
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sctx.all_reduce(g, ctx.logical), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sctx, logical, dim):
        ctx.sctx, ctx.logical, ctx.dim = sctx, logical, dim
        return sctx.all_gather(x, logical, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.sctx.reduce_scatter(g.contiguous(), ctx.logical,
                                        ctx.dim), None, None, None)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sctx, logical, dim):
        ctx.sctx, ctx.logical, ctx.dim = sctx, logical, dim
        return sctx.all_gather(x, logical, dim)

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.sctx.local(ctx.logical, g.shape[ctx.dim])
        return g.narrow(ctx.dim, lo, n), None, None, None


def local_shape(shape: Sequence[int], axes: Sequence[Optional[str]],
                ctx: ShardCtx) -> Tuple[int, ...]:
    """A leaf's shape on this rank: each dimension over its shards."""
    return tuple(ctx.local(a, n)[1] for n, a in zip(shape, axes))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


def split_rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
                  ctx: ShardCtx, logical: str,
                  eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` over a last dimension split over ``logical`` (``x`` and
    ``scale`` are this rank's shards): the mean of squares is the sum of
    squares all-reduced over the axis, over the global width. The sum is
    all-reduced both ways (``enter(psum(...))``): each rank's consumers
    of the variance are its own shard, so its gradient is partial too."""
    m = ctx.size(logical)
    if m == 1:
        return rmsnorm(x, scale, eps)
    dt = x.dtype
    x = x.float()
    ss = ctx.enter(ctx.psum(x.square().sum(dim=-1, keepdim=True), logical),
                   logical)
    y = x * torch.rsqrt(ss / (x.shape[-1] * m) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def nonparam_ln(x: torch.Tensor) -> torch.Tensor:
    """OLMo's LayerNorm without affine parameters."""
    return layernorm(x, None, None)


def apply_norm(kind: str, x: torch.Tensor,
               params: Optional[Params]) -> torch.Tensor:
    """kind: rmsnorm | layernorm | nonparam_ln."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layernorm(x, params["scale"] if params else None,
                         params.get("bias") if params else None)
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(f"unknown norm kind {kind!r}")


def norm_axes(kind: str, lead: Tuple[int, ...]) -> Optional[Axes]:
    lead_ax = ("layers",) * len(lead)
    if kind == "rmsnorm":
        return {"scale": lead_ax + ("embed",)}
    if kind == "layernorm":
        return {"scale": lead_ax + ("embed",), "bias": lead_ax + ("embed",)}
    if kind == "nonparam_ln":
        return None
    raise ValueError(kind)


def init_norm(kind: str, d: int, lead: Tuple[int, ...],
              init: "Init") -> Optional[Params]:
    if kind == "rmsnorm":
        return {"scale": init.full(lead + (d,), 1.0)}
    if kind == "layernorm":
        return {"scale": init.full(lead + (d,), 1.0),
                "bias": init.full(lead + (d,), 0.0)}
    if kind == "nonparam_ln":
        return None
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE (split-half convention)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos, sin of shape (..., S, head_dim // 2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python-number base: no host-to-device copy (a host sync) a call
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos, sin (S, D/2) or (B, S, D/2). The first half of
    the head dims rotates with the second half (not interleaved pairs)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(kind: str, d: int, f: int, lead: Tuple[int, ...],
             init: "Init") -> Params:
    if kind == "swiglu":
        return {"w_gate": init.normal(lead + (d, f)),
                "w_up": init.normal(lead + (d, f)),
                "w_down": init.normal(lead + (f, d))}
    if kind == "gelu":
        return {"w_up": init.normal(lead + (d, f)),
                "b_up": init.full(lead + (f,), 0.0),
                "w_down": init.normal(lead + (f, d)),
                "b_down": init.full(lead + (d,), 0.0)}
    raise ValueError(kind)


def mlp_axes(kind: str, lead: Tuple[int, ...]) -> Axes:
    lead_ax = ("layers",) * len(lead)
    axes = {"w_up": lead_ax + ("embed", "mlp"),
            "w_down": lead_ax + ("mlp", "embed")}
    if kind == "swiglu":
        axes["w_gate"] = lead_ax + ("embed", "mlp")
    elif kind == "gelu":
        axes.update({"b_up": lead_ax + ("mlp",),
                     "b_down": lead_ax + ("embed",)})
    else:
        raise ValueError(kind)
    return axes


def mlp_fwd(kind: str, params: Params, x: torch.Tensor,
            ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), in x's dtype. On a mesh the hidden
    width is this rank's "mlp" shard: column-parallel in, row-parallel
    out, the partial sums all-reduced (reference :194, :200)."""
    dt = x.dtype
    x = ctx.enter(x, "mlp")
    if kind == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        return ctx.psum((F.silu(g) * u) @ params["w_down"].to(dt), "mlp")
    if kind == "gelu":
        h = x @ params["w_up"].to(dt) + params["b_up"].to(dt)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
        return (ctx.psum(h @ params["w_down"].to(dt), "mlp")
                + params["b_down"].to(dt))
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Init, embedding / unembedding
# ---------------------------------------------------------------------------

def winit(shape: Tuple[int, ...], device, gen: torch.Generator,
          scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) float32 weights from the caller's generator (scaled
    in place: no second buffer of the leaf's size)."""
    return torch.randn(shape, device=device, generator=gen).mul_(scale)


class Init:
    """Makes the leaves of ``init_lm``'s tree, float32 on ``device``:
    N(0, scale^2) weights drawn from ``gen`` in call order, constants, and
    a row of values over the last dimension (``fn(device)``, (n,))
    repeated over the others. The ``init_*`` functions say which leaf is
    which; ``LeafSpecs`` records the same calls unmade."""

    def __init__(self, device, gen: Optional[torch.Generator]):
        self.device, self.gen = device, gen

    def normal(self, shape: Tuple[int, ...], scale: float = 0.02):
        return winit(shape, self.device, self.gen, scale)

    def full(self, shape: Tuple[int, ...], value: float):
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)

    def row(self, shape: Tuple[int, ...], fn):
        return fn(self.device).expand(shape).clone()


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf as an ``Init`` call: its global shape, the method and its
    argument (the scale, the value, the row's ``fn``)."""
    shape: Tuple[int, ...]
    kind: str
    arg: Any


class LeafSpecs:
    """``Init``'s calls recorded, nothing made: the tree of ``LeafSpec``
    from which a mesh rank makes its shards (``transformer.init_lm``)."""

    def normal(self, shape, scale: float = 0.02) -> LeafSpec:
        return LeafSpec(tuple(shape), "normal", scale)

    def full(self, shape, value: float) -> LeafSpec:
        return LeafSpec(tuple(shape), "full", value)

    def row(self, shape, fn) -> LeafSpec:
        return LeafSpec(tuple(shape), "row", fn)


def embedding_axes(tie: bool) -> Axes:
    axes = {"tok": ("vocab", "embed")}
    if not tie:
        axes["head"] = ("embed", "vocab")
    return axes


def init_embedding(vocab: int, d: int, tie: bool, init: Init) -> Params:
    params = {"tok": init.normal((vocab, d))}
    if not tie:
        params["head"] = init.normal((d, vocab))
    return params


def embed_tokens(params: Params, tokens: torch.Tensor,
                 compute_dtype: torch.dtype,
                 ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d). On a mesh each rank holds rows
    [lo, lo + V_local) of the table: it looks up its own tokens (the
    others read row 0 and are zeroed) and the pieces are summed over
    "vocab"."""
    tok = ctx.gather(params["tok"], "embed", 1).to(compute_dtype)
    if ctx.size("vocab") == 1:
        return tok[tokens.long()]
    lo, n = ctx.local("vocab", tok.shape[0] * ctx.size("vocab"))
    t = tokens.long() - lo
    mine = (t >= 0) & (t < n)
    x = tok[torch.where(mine, t, torch.zeros_like(t))]
    x = x * mine[..., None].to(compute_dtype)
    return ctx.psum(x, "vocab")


def unembed_matrix(params: Params,
                   ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The (d, vocab) output projection (a view of ``tok`` when tied); on
    a mesh this rank's vocabulary columns, FSDP's "embed" gathered."""
    if "head" in params:
        return ctx.gather(params["head"], "embed", 0)
    return ctx.gather(params["tok"], "embed", 1).t()


def unembed_table(params: Params,
                  ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The (vocab, d) output table the xent kernel reads: ``tok`` itself
    when tied (no copy), else the transposed untied head; on a mesh this
    rank's vocabulary rows."""
    return unembed_matrix(params, ctx).t()
