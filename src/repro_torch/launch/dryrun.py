"""Dry run on H100s: trace every (arch x shape x mesh x variant) cell on
the ``meta`` device and report its work per device (counterpart of
``repro/launch/dryrun.py``).

A cell's step runs on ``meta`` tensors along the route the card runs:
every hand-written kernel takes its ``meta`` route (its shape function:
empty outputs of the kernel's shapes, no launch), so nothing is
allocated and nothing launches, and no GPU is needed. ``launch/cost.py``
counts the trace: FLOPs by dtype, bytes, the peak of live memory,
collective bytes, and the roofline terms of one H100.

Meshes (``--mesh``): ``single`` (16 x 16, "data" x "model") and ``multi``
(2 x 16 x 16, "pod" x "data" x "model"), the reference's, and ``card``
(one H100, no mesh: the trace that ``chip_smoke.py`` phase ``dryrun``
holds to the card). On a mesh the process joins a fake process group of
the mesh's size (``torch.testing._internal.distributed.fake_pg``,
PyTorch's own test helper, imported only here: its collectives move
nothing, and the port's own collectives return empty ``meta`` results)
and traces rank 0's SPMD program: its shards of the parameters,
optimizer state and cache (the reference's rules, ``distributed/
sharding.py``), its rows of the batch, and the collectives it calls.
Every rule shards evenly (a cell that does not is refused with the
reason: arctic's 56 heads over a 16-way "model" axis, a MoE capacity
over the data axes), so every rank runs the same shapes and rank 0
stands for every device. The reference's HLO text parsing has no counterpart: the
collectives report themselves.

  train   : ``ESEngine.es_step`` / ``baseline_step`` / ``pipelined_step``
            (the variant's ``step``) on a meta-batch of ``global_batch``
            with a minibatch of ``global_batch x minibatch_frac`` (0.25
            unless the variant says) and ``seq_chunk`` 1,024: scoring,
            selection, the store update, forward and backward and AdamW.
  prefill : ``models/model.py:prefill`` on a (B, S) cache.
  decode  : one ``decode_step`` on a (B, S) cache (``long_500k`` too).

vlm and encdec cells carry their frontend stubs (``image_embeds``,
``frames``) at the reference's shapes. On ``meta`` the pipelined step's
scoring leg runs inline, before the training leg, so its peak is that of
the two legs in series; on the card the leg runs on a side stream and its
transient can overlap the training leg's, so the card's peak may exceed
the prediction by up to the scoring leg's transient.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both [--variant es]
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \
      --shape train_4k --mesh card           # one H100, no mesh
  python -m repro_torch.launch.dryrun --list

One JSON a cell, ``{arch}__{shape}__{mesh}__{variant}.json``, under
``experiments/dryrun_torch/`` (``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..configs.base import (ALL_SHAPES, ModelConfig, ShapeConfig,
                            cell_is_applicable, shape_by_name)
from ..configs.registry import get_config, list_archs
from ..core.engine import ESConfig, ESEngine, init_train_state
from ..distributed.sharding import check_even, make_ctx
from ..models.model import (cache_axes, decode_step, encoder_len,
                            image_tokens, init_cache, prefill)
from ..models.moe import dispatch_layout
from ..models.transformer import (MESH_FAMILIES, MESH_LATER, init_lm,
                                  param_axes)
from ..optim.adamw import OptConfig
from ..optim.schedule import get_schedule
from .cost import CostCounter, summary, tree_bytes
from .mesh import make_mesh, mesh_info, production_shape

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
MESH_INFO = {"axis_names": [], "shape": [], "n_devices": 1}
SEED = 0             # the random weights and batch (on the card)
SEQ_CHUNK = 1024     # scoring's sequence chunk, unless the variant says


@dataclasses.dataclass(frozen=True)
class Variant:
    """A dry-run configuration delta (the reference's)."""
    step: str = "es"                      # es | baseline | pipelined (train)
    cfg_replace: tuple = ()               # ModelConfig field overrides
    es_replace: tuple = ()                # ESConfig overrides


# the reference's table (``repro/launch/dryrun.py:VARIANTS``)
VARIANTS: Dict[str, Variant] = {
    "es": Variant(step="es"),
    "noes": Variant(step="baseline"),
    "pipelined": Variant(step="pipelined"),
    "fsdp_off": Variant(cfg_replace=(("fsdp_params", False),)),
    "fsdp_on": Variant(cfg_replace=(("fsdp_params", True),)),
    "remat_full": Variant(cfg_replace=(("remat_policy", "full"),)),
    "remat_none": Variant(cfg_replace=(("remat_policy", "none"),)),
    "moe_tp": Variant(cfg_replace=(("moe_sharding", "tp"),)),
    "moe_ep": Variant(cfg_replace=(("moe_sharding", "ep"),)),
    "kv_shard": Variant(cfg_replace=(("shard_kv_heads", True),)),
    "kv_replicate": Variant(cfg_replace=(("shard_kv_heads", False),)),
    "b_over_B_50": Variant(es_replace=(("minibatch_frac", 0.5),)),
    "b_over_B_12.5": Variant(es_replace=(("minibatch_frac", 0.125),)),
    "xent_chunk_512": Variant(es_replace=(("seq_chunk", 512),)),
    "xent_chunk_2048": Variant(es_replace=(("seq_chunk", 2048),)),
    "param_bf16": Variant(cfg_replace=(("param_dtype", "bfloat16"),)),
    "cap_0.75": Variant(cfg_replace=(("capacity_factor", 0.75),)),
    "attn_chunk_1024": Variant(cfg_replace=(("attn_chunk_q", 1024),)),
    "attn_chunk_2048": Variant(cfg_replace=(("attn_chunk_q", 2048),)),
    "moe_ep_bf16": Variant(cfg_replace=(("moe_sharding", "ep"),
                                        ("param_dtype", "bfloat16"))),
    "es_ungrouped": Variant(cfg_replace=(("moe_groups", 1),)),
    "moe_grouped": Variant(cfg_replace=(("moe_groups", 0),)),
    "moe_grouped_ep": Variant(cfg_replace=(("moe_groups", 0),
                                           ("moe_sharding", "ep"))),
    "moe_grouped_cap75": Variant(cfg_replace=(("moe_groups", 0),
                                              ("capacity_factor", 0.75))),
    "moe_tp_bf16": Variant(cfg_replace=(("moe_sharding", "tp"),
                                        ("param_dtype", "bfloat16"))),
    "best": Variant(cfg_replace=(("param_dtype", "bfloat16"),
                                 ("remat_policy", "selective"))),
}

# ModelConfig fields that only place a model over several devices
SHARDING_FIELDS = ("fsdp_params", "moe_sharding", "shard_kv_heads")


def refusal(variant_name: str, cfg: Optional[ModelConfig] = None,
            on_mesh: bool = False) -> Optional[str]:
    """Why the port refuses a variant (on one card, or on a mesh for
    ``cfg``'s family), or None."""
    fields = [f for f, _ in VARIANTS[variant_name].cfg_replace
              if f in SHARDING_FIELDS]
    if not on_mesh:
        if fields:
            return (f"variant {variant_name} sets {', '.join(fields)}: a "
                    f"one-card cell shards no model (--mesh single or "
                    f"multi)")
        return None
    if cfg is not None and cfg.family not in MESH_FAMILIES:
        return f"{cfg.name}: {MESH_LATER[cfg.family]}"
    return None


def apply_variant(cfg: ModelConfig, variant: Variant
                  ) -> Tuple[ModelConfig, Dict[str, Any], float]:
    if variant.cfg_replace:
        cfg = dataclasses.replace(cfg, **dict(variant.cfg_replace))
    es_kw = dict(variant.es_replace)
    frac = es_kw.pop("minibatch_frac", 0.25)
    return cfg, es_kw, frac


# ---------------------------------------------------------------------------
# Inputs: the batch, state and cache of a cell on a device
# ---------------------------------------------------------------------------

def stub_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Tuple]:
    """The frontend stubs a vlm or encdec batch carries (bfloat16), as
    ``repro/launch/inputs.py:train_batch_specs``."""
    if cfg.is_encdec:
        return {"frames": (B, encoder_len(cfg, S),
                           cfg.frontend_dim or cfg.d_model)}
    if cfg.family == "vlm":
        return {"image_embeds": (B, image_tokens(cfg), cfg.d_model)}
    return {}


def make_batch(cfg: ModelConfig, B: int, S: int, device,
               gen: Optional[torch.Generator], *,
               train: bool = True) -> Dict[str, torch.Tensor]:
    """A (B, S) batch on ``device``: empty on ``meta``, else tokens and
    labels drawn from ``gen`` and standard normal stubs."""
    device = torch.device(device)
    meta = device.type == "meta"

    def ints(shape, high):
        if meta:
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(0, high, shape, generator=gen,
                             device=device).to(torch.int32)
    batch = {"tokens": ints((B, S), cfg.vocab_size)}
    if train:
        batch["labels"] = ints((B, S), cfg.vocab_size)
        batch["sample_ids"] = (
            torch.empty(B, dtype=torch.int32, device=device) if meta
            else torch.arange(B, dtype=torch.int32, device=device))
    for name, shape in stub_specs(cfg, B, S).items():
        batch[name] = (
            torch.empty(shape, dtype=torch.bfloat16, device=device) if meta
            else torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16))
    return batch


@dataclasses.dataclass
class Prepared:
    """A cell ready to run: ``step()`` runs it once; ``args`` are the
    tensors it reads and writes (the argument bytes); a train cell's
    ``engine`` is the ``ESEngine`` that ``step`` calls."""
    step: Callable[[], Any]
    args: Tuple
    tokens_meta: int
    tokens_bp: int
    engine: Any = None


def mesh_kind(shape: ShapeConfig) -> str:
    """The rules' kind of a cell (``make_rules``): long_500k is "long"."""
    return "long" if shape.name == "long_500k" else shape.kind


def prepare(cfg: ModelConfig, shape: ShapeConfig,
            variant: Variant = VARIANTS["es"], device="meta", *,
            minibatch: Optional[int] = None, mesh=None,
            params: Optional[Dict] = None,
            batch: Optional[Dict[str, torch.Tensor]] = None) -> Prepared:
    """Build a cell's state, batch (or cache) and step on ``device``;
    ``minibatch`` replaces ``global_batch x minibatch_frac``. On a
    ``mesh`` this rank's part: its shards of the state and cache (the
    reference's rules for the cell's kind) and its rows of the batch.
    ``params`` and ``batch`` (this rank's) replace the random ones."""
    device = torch.device(device)
    cfg, es_kw, frac = apply_variant(cfg, variant)
    ctx = make_ctx(cfg, mesh, mesh_kind(shape))
    B, S = shape.global_batch, shape.seq_len
    Bl = ctx.local("batch", B)[1]
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(SEED))
    if shape.kind == "train":
        b = minibatch or max(1, int(B * frac))
        es_cfg = ESConfig(minibatch=b,
                          seq_chunk=es_kw.pop("seq_chunk", SEQ_CHUNK),
                          **es_kw)
        opt_cfg = OptConfig(state_dtype=cfg.optimizer_dtype)
        engine = ESEngine(cfg, es_cfg, opt_cfg, get_schedule("constant", 1),
                          ctx=ctx)
        state = init_train_state(cfg, es_cfg, opt_cfg, SEED, device,
                                 params=params, meta_batch=B, ctx=ctx)
        batch = batch if batch is not None else make_batch(
            cfg, Bl, S, device, gen)
        if variant.step == "pipelined":
            nxt = make_batch(cfg, Bl, S, device, gen)
            fn = lambda: engine.pipelined_step(state, (batch, nxt))  # noqa
            batches: Tuple = (batch, nxt)
        else:
            fn = {"es": engine.es_step,
                  "baseline": engine.baseline_step}[variant.step]
            fn = (lambda f=fn: f(state, batch))
            batches = (batch,)
        bp = B * S if variant.step == "baseline" else min(b, B) * S
        return Prepared(fn, (state.params, state.opt, state.scores,
                             state.pending_w, state.cadence, *batches),
                        B * S, bp, engine)
    if params is None:
        params = init_lm(cfg, gen, device, ctx)
    cache = init_cache(cfg, B, S, device=device, ctx=ctx)
    if shape.kind == "prefill":
        batch = batch if batch is not None else make_batch(
            cfg, Bl, S, device, gen, train=False)
        return Prepared(lambda: prefill(cfg, params, batch, cache, ctx),
                        (params, batch, cache), B * S, 0)
    tokens = batch["tokens"] if batch is not None else make_batch(
        cfg, Bl, 1, device, gen, train=False)["tokens"]
    pos = torch.full((1,), S - 1, dtype=torch.long, device=device)
    return Prepared(lambda: decode_step(cfg, params, tokens, cache, pos,
                                        ctx),
                    (params, tokens, cache, pos), B, 0)


def count(prepared: Prepared, info: Optional[Dict] = None
          ) -> Dict[str, Any]:
    """Run the cell's step once under the cost counter -> its summary
    (``info``: the mesh's, for the collective term)."""
    args_bytes = tree_bytes(*prepared.args)
    with CostCounter() as counter:
        out = prepared.step()
    del out
    return summary(counter, args_bytes, info)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0
    (PyTorch's test helper ``FakeStore`` / backend "fake", imported only
    here: a dry run's group moves nothing). Torn down on exit, so a
    process can trace several meshes one after another."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A mesh of ``shape`` over a fake group of its size (``fake_group``)."""
    n = 1
    for x in shape:
        n *= x
    with fake_group(n):
        yield make_mesh(shape, names)


def uneven(cfg: ModelConfig, shape: ShapeConfig, b: int, ctx
           ) -> Optional[str]:
    """Why a cell's parameters, cache or batch do not split evenly under
    ``ctx`` (the batch and the minibatch over the data axes), or None."""
    params = init_lm(cfg, None, "meta")
    shapes = {"params": _shapes(params)}
    axes = {"params": param_axes(cfg)}
    if shape.kind != "train":
        shapes["cache"] = _shapes(init_cache(cfg, shape.global_batch,
                                             shape.seq_len, device="meta"))
        axes["cache"] = cache_axes(cfg)
    why = check_even(shapes, axes, ctx)
    dp = ctx.size("batch")
    rows = [shape.global_batch] + ([b] if shape.kind == "train" else [])
    bad = [f"batch {n} over {dp}" for n in rows if n % dp]
    # the MoE dispatch of each forward's tokens (a capacity split over the
    # data axes must split evenly: the reference's partitioner pads it)
    if cfg.num_experts:
        B, S = shape.global_batch, shape.seq_len
        calls = {"train": (B * S, b * S), "prefill": (B * S,),
                 "decode": (B,)}[shape.kind]
        for T in calls:
            try:
                dispatch_layout(ctx, T, cfg.num_experts,
                                cfg.num_experts_per_tok,
                                cfg.capacity_factor, cfg.moe_groups)
            except (ValueError, NotImplementedError) as e:
                bad.append(f"the MoE dispatch of {T} tokens: {e}")
    # whole heads a rank: the projections' H x hd columns may split evenly
    # where the heads do not (arctic's 56 over 16; the reference's
    # partitioner pads them to 64, which the port does not); an SSM has no
    # attention, and a Mamba2 block's SSD heads split over "mlp"
    heads = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
    if cfg.family == "ssm":
        heads = {}
    if cfg.family in ("ssm", "hybrid"):
        heads["mlp"] = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    for name, n in heads.items():
        m = ctx.size(name)
        if n % m:
            bad.append(f"{name} {n} over "
                       f"{'/'.join(ctx.dims(name))} {m}")
    return "; ".join(([why] if why else []) + bad) or None


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def run_cell(arch: str, shape_name: str, variant_name: str = "es",
             mesh: str = "card", mesh_shape: Optional[Sequence[int]] = None
             ) -> Dict[str, Any]:
    """One (arch x shape x mesh x variant) cell traced on ``meta``: the
    reference's keys, per device, and ``fits_one_card``. ``mesh`` is
    "card" (one H100, no mesh), "single" or "multi" (the reference's), or
    any name with an explicit ``mesh_shape`` (("data", "model"), or
    ("pod", "data", "model") for three dims)."""
    shape = shape_by_name(shape_name)
    variant = VARIANTS[variant_name]
    cfg, _, frac = apply_variant(get_config(arch), variant)
    on_mesh = mesh != "card"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "variant": variant_name, "kind": shape.kind,
        "params": cfg.n_params(), "active_params": cfg.n_active_params(),
    }
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        result["skipped"] = why
        return result
    why = refusal(variant_name, cfg, on_mesh)
    if why:
        result["refused"] = why
        return result
    t0 = time.time()
    if not on_mesh:
        result["mesh_info"] = dict(MESH_INFO)
        prepared = prepare(get_config(arch), shape, variant)
        result["tokens_meta"] = prepared.tokens_meta
        result["tokens_bp"] = prepared.tokens_bp
        result.update(count(prepared))
        result["trace_s"] = time.time() - t0
        return result
    if mesh_shape is not None:
        dims = tuple(mesh_shape)
        names = production_shape(multi_pod=len(dims) == 3)[1]
    else:
        dims, names = production_shape(multi_pod=mesh == "multi")
    with fake_mesh(dims, names) as m:
        info = mesh_info(m)
        result["mesh_info"] = info
        ctx = make_ctx(cfg, m, mesh_kind(shape))
        why = uneven(cfg, shape, max(1, int(shape.global_batch * frac)), ctx)
        if why:
            result["refused"] = f"does not split evenly: {why}"
            return result
        prepared = prepare(get_config(arch), shape, variant, mesh=m)
        result["tokens_meta"] = prepared.tokens_meta
        result["tokens_bp"] = prepared.tokens_bp
        result.update(count(prepared, info))
    result["trace_s"] = time.time() - t0
    return result


def cell_path(out_dir: Path, arch: str, shape: str, mesh: str,
              variant: str) -> Path:
    return out_dir / f"{arch}__{shape}__{mesh}__{variant}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--variant", default="es", choices=sorted(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            cfg = get_config(a)
            for s in ALL_SHAPES:
                ok, why = cell_is_applicable(cfg, s)
                print(f"{a:26s} {s.name:12s} "
                      f"{'run' if ok else 'SKIP: ' + why}")
        return

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in ALL_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    t_all = time.time()
    for arch, shape in cells:
        for mesh in meshes:
            path = cell_path(out_dir, arch, shape, mesh, args.variant)
            if path.exists() and not args.force:
                print(f"[skip cached] {path.name}")
                continue
            print(f"[run] {arch} x {shape} x {mesh} x {args.variant}",
                  flush=True)
            try:
                res = run_cell(arch, shape, args.variant, mesh)
            except Exception as e:
                res = {"arch": arch, "shape": shape, "mesh": mesh,
                       "variant": args.variant, "error": repr(e),
                       "traceback": traceback.format_exc()}
                print(f"[FAIL] {path.name}: {e!r}", flush=True)
            path.write_text(json.dumps(res, indent=1, default=str))
            for key in ("refused", "skipped"):
                if key in res:
                    print(f"  -> {key}: {res[key]}", flush=True)
            rt = res.get("roofline")
            if rt:
                print(f"  -> flops={res['flops']:.4e} "
                      f"bytes={res['bytes']:.4e} "
                      f"coll={res['collective_bytes_total']:.4e} "
                      f"peak={res['memory']['peak_bytes']:.4e} "
                      f"fits={res['fits_one_card']} "
                      f"compute={rt['compute_s']:.4f}s "
                      f"memory={rt['memory_s']:.4f}s "
                      f"collective={rt['collective_s']:.4f}s "
                      f"bottleneck={rt['bottleneck']}", flush=True)
    print(f"[done] {len(cells) * len(meshes)} cells in "
          f"{time.time() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
