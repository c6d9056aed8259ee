"""Dry run on one H100: trace every (arch x shape x variant) cell on the
``meta`` device and report its work (counterpart of
``repro/launch/dryrun.py``).

A cell is one card. Its step runs on ``meta`` tensors along the route the
card runs: every hand-written kernel takes its ``meta`` route (its shape
function: empty outputs of the kernel's shapes, no launch), so nothing is
allocated and nothing launches, and no GPU is needed. ``launch/cost.py``
counts the trace: FLOPs by dtype, bytes, the peak of live memory, and the
roofline terms of one H100. The reference's XLA parts have no
counterpart here: the 512 placeholder devices, the pod meshes, the
collectives and the HLO text (the port shards no model).

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
  python -m repro_torch.launch.dryrun --all [--variant es] [--force]
  python -m repro_torch.launch.dryrun --list

One JSON a cell under ``experiments/dryrun_torch/`` (``--out``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import (ALL_SHAPES, ModelConfig, ShapeConfig,
                            cell_is_applicable, shape_by_name)
from ..configs.registry import get_config, list_archs
from ..core.engine import ESConfig, ESEngine, init_train_state
from ..models.model import (decode_step, encoder_len, image_tokens,
                            init_cache, prefill)
from ..models.transformer import init_lm
from ..optim.adamw import OptConfig
from ..optim.schedule import get_schedule
from .cost import CostCounter, summary, tree_bytes

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


def refusal(variant_name: str) -> Optional[str]:
    """Why the port refuses a variant, or None."""
    fields = [f for f, _ in VARIANTS[variant_name].cfg_replace
              if f in SHARDING_FIELDS]
    if fields:
        return (f"variant {variant_name} sets {', '.join(fields)}: the port "
                f"shards no model (a cell is one card)")
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
    tensors it reads and writes (the argument bytes)."""
    step: Callable[[], Any]
    args: Tuple
    tokens_meta: int
    tokens_bp: int


def prepare(cfg: ModelConfig, shape: ShapeConfig,
            variant: Variant = VARIANTS["es"], device="meta", *,
            minibatch: Optional[int] = None) -> Prepared:
    """Build a cell's state, batch (or cache) and step on ``device``;
    ``minibatch`` replaces ``global_batch x minibatch_frac``."""
    device = torch.device(device)
    cfg, es_kw, frac = apply_variant(cfg, variant)
    B, S = shape.global_batch, shape.seq_len
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(SEED))
    if shape.kind == "train":
        b = minibatch or max(1, int(B * frac))
        es_cfg = ESConfig(minibatch=b,
                          seq_chunk=es_kw.pop("seq_chunk", SEQ_CHUNK),
                          **es_kw)
        opt_cfg = OptConfig(state_dtype=cfg.optimizer_dtype)
        engine = ESEngine(cfg, es_cfg, opt_cfg, get_schedule("constant", 1))
        state = init_train_state(cfg, es_cfg, opt_cfg, SEED, device,
                                 meta_batch=B)
        batch = make_batch(cfg, B, S, device, gen)
        if variant.step == "pipelined":
            nxt = make_batch(cfg, B, S, device, gen)
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
                        B * S, bp)
    params = init_lm(cfg, gen, device)
    cache = init_cache(cfg, B, S, device=device)
    if shape.kind == "prefill":
        batch = make_batch(cfg, B, S, device, gen, train=False)
        return Prepared(lambda: prefill(cfg, params, batch, cache),
                        (params, batch, cache), B * S, 0)
    tokens = make_batch(cfg, B, 1, device, gen, train=False)["tokens"]
    pos = torch.full((1,), S - 1, dtype=torch.long, device=device)
    return Prepared(lambda: decode_step(cfg, params, tokens, cache, pos),
                    (params, tokens, cache, pos), B, 0)


def count(prepared: Prepared) -> Dict[str, Any]:
    """Run the cell's step once under the cost counter -> its summary."""
    args_bytes = tree_bytes(*prepared.args)
    with CostCounter() as counter:
        out = prepared.step()
    del out
    return summary(counter, args_bytes)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, variant_name: str = "es"
             ) -> Dict[str, Any]:
    """One (arch x shape x variant) cell traced on ``meta``: the
    reference's keys, per card, and ``fits_one_card``."""
    shape = shape_by_name(shape_name)
    variant = VARIANTS[variant_name]
    cfg, _, _ = apply_variant(get_config(arch), variant)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "single",
        "variant": variant_name, "kind": shape.kind,
        "params": cfg.n_params(), "active_params": cfg.n_active_params(),
    }
    why = refusal(variant_name)
    if why:
        result["refused"] = why
        return result
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        result["skipped"] = why
        return result
    result["mesh_info"] = dict(MESH_INFO)
    t0 = time.time()
    prepared = prepare(get_config(arch), shape, variant)
    result["tokens_meta"] = prepared.tokens_meta
    result["tokens_bp"] = prepared.tokens_bp
    result.update(count(prepared))
    result["collectives"] = {}
    result["collective_bytes_total"] = 0
    result["trace_s"] = time.time() - t0
    return result


def cell_path(out_dir: Path, arch: str, shape: str, variant: str) -> Path:
    return out_dir / f"{arch}__{shape}__{variant}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
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
    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in ALL_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    for arch, shape in cells:
        path = cell_path(out_dir, arch, shape, args.variant)
        if path.exists() and not args.force:
            print(f"[skip cached] {path.name}")
            continue
        print(f"[run] {arch} x {shape} x {args.variant}", flush=True)
        try:
            res = run_cell(arch, shape, args.variant)
        except Exception as e:
            res = {"arch": arch, "shape": shape, "variant": args.variant,
                   "error": repr(e), "traceback": traceback.format_exc()}
            print(f"[FAIL] {path.name}: {e!r}", flush=True)
        path.write_text(json.dumps(res, indent=1, default=str))
        for key in ("refused", "skipped"):
            if key in res:
                print(f"  -> {key}: {res[key]}", flush=True)
        rt = res.get("roofline")
        if rt:
            print(f"  -> flops={res['flops']:.4e} bytes={res['bytes']:.4e} "
                  f"peak={res['memory']['peak_bytes']:.4e} "
                  f"fits={res['fits_one_card']} "
                  f"compute={rt['compute_s']:.4f}s "
                  f"memory={rt['memory_s']:.4f}s "
                  f"bottleneck={rt['bottleneck']}", flush=True)


if __name__ == "__main__":
    main()
