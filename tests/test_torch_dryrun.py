"""PyTorch port: the dry run on one card (``repro_torch.launch.dryrun``).

* The shape cells and the parameter counts equal the reference's.
* FLOP parity: the port's ``meta`` count of the qwen1.5 smoke ``es_step``
  (B 16, S 32, minibatch 4), ``prefill`` and ``decode_step`` against
  ``repro.launch.hlo_cost.analyze`` of the reference's compiled steps on
  one CPU device, within 2 %. The one gap: the reference picks each
  token's logit with a one-hot einsum (``repro/models/losses.py:
  _chunk_nll``, 2 x tokens x V FLOPs a scored or trained token), the
  port with a gather, which is no dot; prefill and decode agree exactly.
* Each kernel's ``meta`` route: the shapes and dtypes of the plain
  version's outputs on CPU inputs, no launch counted, and the FLOPs of a
  lone kernel or matmul exact.
* A full-width cell traces on ``meta`` in seconds; ``long_500k`` of a
  dense arch is skipped and a sharding variant refused on one card (the
  variants that place experts too), with the reference's reasons.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import FAST, one_torch_thread  # noqa: F401 (autouse)
from repro.configs import base as jbase
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import engine as jengine
from repro.launch.hlo_cost import analyze
from repro.models import model as jmodel
from repro.models.layers import ShardCtx
from repro.models.transformer import init_lm as jinit_lm
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import all_configs, get_smoke_config
from repro_torch.core.scores import make_store
from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
from repro_torch.kernels.score_update import ops as score_ops
from repro_torch.kernels.segsum.ops import (segment_sum,
                                            segment_sum_autograd,
                                            segment_sum_grad)
from repro_torch.kernels.xent.ops import (fused_xent, xent_combine,
                                          xent_partials)
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter

B, S, b = 16, 32, 4


def test_shape_cells_and_param_counts_match_reference():
    assert [dataclasses.astuple(s) for s in tbase.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.ALL_SHAPES]
    assert tbase.shape_by_name("long_500k") == tbase.LONG_500K
    for name, cfg in all_configs():
        ref = jget_config(name)
        assert cfg.n_params() == ref.n_params(), name
        assert cfg.n_active_params() == ref.n_active_params(), name
        for ts, js in zip(tbase.ALL_SHAPES, jbase.ALL_SHAPES):
            assert tbase.cell_is_applicable(cfg, ts) == \
                jbase.cell_is_applicable(ref, js), (name, ts.name)


def _hlo_flops(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile(
        compiler_options=FAST).as_text())["flops"]


def test_meta_flops_match_reference_hlo_cost():
    """es_step, prefill and decode_step of the qwen1.5 smoke config: one
    reference jit each, one meta trace each, within 2 %."""
    jcfg = jget_smoke_config("qwen1.5-0.5b")
    es = jengine.ESConfig(minibatch=b, n_train=64, seq_chunk=1024)
    opt = OptConfig()
    steps = jengine.ESEngine(jcfg, es, opt, get_schedule("constant", 1),
                             ShardCtx()).make_steps()
    sds = jax.ShapeDtypeStruct
    state = jax.eval_shape(
        lambda k: jengine.init_train_state(jcfg, es, opt, k, B),
        jax.random.PRNGKey(0))
    tok = sds((B, S), jnp.int32)
    batch = {"tokens": tok, "labels": tok,
             "sample_ids": sds((B,), jnp.int32)}
    params = jax.eval_shape(lambda k: jinit_lm(jcfg, k)[0],
                            jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, B, S))
    want = {
        "train": _hlo_flops(steps["es_step"], state, batch),
        "prefill": _hlo_flops(
            lambda p, bt, c: jmodel.prefill(jcfg, p, bt, c, ShardCtx()),
            params, {"tokens": tok}, cache),
        "decode": _hlo_flops(
            lambda p, t, c, pos: jmodel.decode_step(jcfg, p, t, c, pos,
                                                    ShardCtx()),
            params, sds((B, 1), jnp.int32), cache, sds((), jnp.int32)),
    }
    cfg = get_smoke_config("qwen1.5-0.5b")
    got = {kind: dryrun.count(dryrun.prepare(
        cfg, tbase.ShapeConfig(kind, S, B, kind), minibatch=b))
        for kind in want}
    for kind, ref in want.items():
        flops = got[kind]["flops"]
        assert ref > 0 and abs(flops / ref - 1) < 0.02, (kind, flops, ref)
    # the one gap: the one-hot einsum over B scored and b trained rows
    onehot = 2 * (B + b) * S * jcfg.vocab_size
    assert want["train"] - onehot == got["train"]["flops"]
    # the card's route: a flash launch a layer, xent's two, the store's
    L = cfg.num_layers
    assert got["train"]["kernel_launches"] == {
        "flash_attn": L, "xent_partials": 1, "xent_combine": 1,
        "score_update": 1}
    assert got["prefill"]["kernel_launches"] == {"flash_attn": L}
    assert got["decode"]["kernel_launches"] == {}


def _kernel_case(name):
    """-> (fn over tensors, CPU inputs, FLOPs of one call, launch
    counters that the meta route must leave alone, the kernels it
    reports to the cost counter)."""
    g = torch.Generator().manual_seed(0)
    if name == "matmul":
        a, w = torch.randn(128, 256, generator=g), torch.randn(256, 512,
                                                             generator=g)
        return (lambda x, y: x @ y), [a, w], 2 * 128 * 256 * 512, [], {}
    if name == "flash":
        q = torch.randn(2, 64, 4, 32, generator=g).to(torch.bfloat16)
        k = torch.randn(2, 64, 2, 32, generator=g).to(torch.bfloat16)
        return ((lambda q, k, v: gqa_flash_attention(q, k, v)), [q, k, k],
                4 * 2 * 4 * 64 * 64 * 32, [gqa_flash_attention],
                {"flash_attn": 1})
    if name == "xent":
        h = torch.randn(48, 64, generator=g).to(torch.bfloat16)
        w = torch.randn(600, 64, generator=g).to(torch.bfloat16)
        lab = torch.randint(0, 600, (48,), generator=g).to(torch.int32)
        return (fused_xent, [h, w, lab], 2 * 48 * 600 * 64,
                [fused_xent, xent_partials, xent_combine],
                {"xent_partials": 1, "xent_combine": 1})
    if name == "segsum":
        nll = torch.rand(3, 40, generator=g).requires_grad_()
        seg = torch.randint(0, 5, (3, 40), generator=g).to(torch.int32)
        mask = torch.rand(3, 40, generator=g) > 0.2

        def fn(nll, seg, mask):
            sums, counts = segment_sum_autograd(nll, seg, mask,
                                                max_segments=4)
            return (sums, counts,
                    torch.autograd.grad(sums.sum(), nll)[0])
        return fn, [nll, seg, mask], 0, [segment_sum, segment_sum_grad], \
            {"segment_sum": 1, "segment_sum_grad": 1}

    # the f32 and int8 stores: four kernels, updated in place
    def fn(ids, losses):
        out = []
        for quant in (False, True):
            store = make_store(quantize=quant, block=16, residual_rows=64)
            leaf = store.init_leaf(256, ids.device)
            store.update(leaf, ids, losses, 0.2, 0.9, fused=True)
            out += [getattr(leaf, f.name)
                    for f in dataclasses.fields(leaf)]
        return out
    ids = torch.randint(0, 256, (32,), generator=g).to(torch.int32)
    return fn, [ids, torch.rand(32, generator=g)], 0, [
        score_ops.fused_score_update, score_ops.quant_grow_scales,
        score_ops.quant_ring_slots, score_ops.fused_quant_score_update], {
            "score_update": 1, "quant_grow_scales": 1,
            "quant_ring_slots": 1, "quant_score_update": 1}


@pytest.mark.parametrize("name", ["matmul", "flash", "xent", "segsum",
                                  "store"])
def test_meta_route_of_each_kernel(name):
    fn, args, flops, counters, reports = _kernel_case(name)
    want = fn(*args)
    before = [c.launches for c in counters]
    meta = [a.detach().to("meta").requires_grad_(a.requires_grad)
            for a in args]
    with CostCounter() as counter:
        got = fn(*meta)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    assert [c.launches for c in counters] == before
    assert dict(counter.launches) == reports   # the card's route, no plain
    assert counter.total_flops == flops
    assert counter.bytes > 0


def test_full_width_cell_skips_and_refusals():
    res = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "es")
    assert res["trace_s"] < 10, res["trace_s"]
    assert res["params"] == tbase.ModelConfig(**dataclasses.asdict(
        jget_config("qwen1.5-0.5b"))).n_params() == 463_863_808
    assert res["flops"] > 0 and res["bytes"] > 0
    assert res["kernel_launches"] == {"flash_attn": 24, "xent_partials": 1,
                                      "xent_combine": 1, "score_update": 1}
    assert res["mesh_info"]["n_devices"] == 1
    rt = res["roofline"]
    assert rt["collective_s"] == 0 and rt["step_s_lower_bound"] == max(
        rt["compute_s"], rt["memory_s"])
    assert res["fits_one_card"] == (res["memory"]["peak_bytes"] <= 80e9)
    skip = dryrun.run_cell("llama3-8b", "long_500k")
    ok, why = jbase.cell_is_applicable(jget_config("llama3-8b"),
                                       jbase.LONG_500K)
    assert not ok and skip["skipped"] == why and "flops" not in skip
    refused = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "fsdp_on")
    assert "shards no model" in refused["refused"]
    # the variants that place experts shard a model: a mesh's, not one
    # card's; the dispatch variants run on one card
    for variant in ("moe_tp", "moe_ep", "moe_grouped_ep", "moe_tp_bf16"):
        got = dryrun.run_cell("grok-1-314b", "decode_32k", variant)
        assert "sets moe_sharding" in got["refused"], variant
    assert dryrun.refusal("moe_grouped") is None
    assert dryrun.refusal("es_ungrouped") is None
