"""The one subprocess of ``tests/test_torch_mesh.py`` (four host devices
for JAX: run with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

    python tests/_torch_mesh_child.py main OUT_DIR
    python tests/_torch_mesh_child.py rank R PORT OUT_DIR   (started by main)

``main`` writes ``OUT_DIR/result.json`` with, for each case of ``CASES``
on a (2, 2) ("data", "model") mesh (B 16, S 32, b 4): qwen1.5 smoke;
llama3 smoke with ``fsdp_params=True, shard_kv_heads=False``; grok smoke
(TP experts) with ``moe_groups`` 0 (grouped dispatch) and 1 (global
dispatch, the capacity split over "data"); arctic smoke (EP experts and
the dense residual) with ``moe_groups`` 0; mamba2 smoke (SSD heads over
"mlp"); zamba2 smoke (its Mamba2 layers and the shared block):

* ``ref``: the reference's ``es_step``, ``prefill`` and ``decode_step``
  lowered on an ``AxisType.Auto`` mesh of four host devices (in the rank
  processes, a quarter of the cases each), their
  per-device FLOPs and collectives (``hlo_cost.analyze``); a MoE case's
  decode step at the serving batch SB, whose 4 tokens make one dispatch
  group spanning both data ranks;
* ``port``: the port's trace of the same cells under a fake group of 4
  (``dryrun.prepare`` / ``dryrun.count``): FLOPs, collectives, launches;
* ``ranks``: four gloo ranks on the CPU, each running the port's sharded
  ``es_step``, ``prefill`` and four ``decode_step``s on its shards of the
  reference's float32 parameters, batch and Gumbel noise, held to the
  reference's one-device outputs (a MoE case's too: the reference routes
  with the mesh's dispatch groups, ``_one_device_ctx``, and every MoE
  call's expert ids and kept slots are compared); each collective of
  ``ShardCtx`` on known tensors; and the engine's other steps and the
  server on the mesh against the one-process port (``_paths_held``);
  for the SSM cases the replicated Mamba2 leaves bitwise equal over
  "model" after the step, and zamba2's serving under the "long" rules
  (its shared block's cache sequence over "data", and over ("pod",
  "data") on a (2, 1, 2) mesh); and checkpoints of a model-sharded state
  (``_ckpt_held``: qwen1.5 and mamba2 smoke under FSDP saved from the
  four ranks, restored onto the same grid and onto one process).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

B, S, b, N = 16, 32, 4, 64
P, GEN, SB = 16, 4, 4          # serving: prompt, decode steps, batch
ATOL, RTOL = 1e-5, 1e-4        # test_torch_families.py's
# case -> (arch, its smoke config's overrides)
CASES = {"qwen1.5-0.5b": ("qwen1.5-0.5b", {}),
         "llama3-8b": ("llama3-8b", {"fsdp_params": True,
                                     "shard_kv_heads": False}),
         "grok-g0": ("grok-1-314b", {"moe_groups": 0}),
         "grok-g1": ("grok-1-314b", {"moe_groups": 1}),
         "arctic-g0": ("arctic-480b", {"moe_groups": 0}),
         "mamba2-780m": ("mamba2-780m", {}),
         "zamba2-2.7b": ("zamba2-2.7b", {})}
MOE = ("grok-g0", "grok-g1", "arctic-g0")
SSM = ("mamba2-780m", "zamba2-2.7b")
# a Mamba2 block's leaves whole on every rank (``models/ssm.py``)
SSM_REPLICATED = ("w_bc", "w_dt", "conv_bc", "dt_bias", "A_log", "D")
# the checkpoint cases: (arch, its smoke config under FSDP)
CKPT = ("qwen1.5-0.5b", "mamba2-780m")
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _cfgs(case, **over):
    from repro.configs.registry import get_smoke_config
    from repro_torch.configs import ModelConfig
    arch, fields = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **fields, **over)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def decode_batch(case):
    """The batch of a case's decode cell: SB for MoE (a dispatch group
    spanning the data ranks), B for the dense cases."""
    return SB if case in MOE else B


# ---------------------------------------------------------------------------
# the reference on a (2, 2) mesh: per-device FLOPs and collectives
# ---------------------------------------------------------------------------

def ref_mesh_costs(arch):
    import jax
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig
    from repro.core import engine as jengine
    from repro.distributed.sharding import axes_to_sharding, make_ctx
    from repro.launch.hlo_cost import analyze
    from repro.launch.inputs import (abstract_params_and_axes,
                                     abstract_train_state, decode_specs,
                                     prefill_specs, train_batch_specs)
    from repro.models import model as jmodel
    from repro.optim.adamw import OptConfig
    from repro.optim.schedule import get_schedule
    cfg, _ = _cfgs(arch)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}

    def cost(jf, *args):
        a = analyze(jf.lower(*args).compile(compiler_options=FAST).as_text())
        return {"flops": a["flops"],
                "collectives": {k: v for k, v in a["collectives"].items()
                                if v["count"]}}
    with mesh:
        ctx = make_ctx(cfg, mesh, "train")
        es = jengine.ESConfig(minibatch=b, n_train=N, seq_chunk=0)
        opt = OptConfig()
        steps = jengine.ESEngine(cfg, es, opt, get_schedule("constant", 1),
                                 ctx).make_steps()
        st, st_sh = abstract_train_state(cfg, es, opt, B, ctx)
        bt, bt_sh = train_batch_specs(cfg, ShapeConfig("t", S, B, "train"),
                                      ctx)
        out["train"] = cost(jax.jit(steps["es_step"],
                                    in_shardings=(st_sh, bt_sh)), st, bt)
        for kind in ("prefill", "decode"):
            ctx = make_ctx(cfg, mesh, kind)
            ps, axes = abstract_params_and_axes(cfg)
            p_sh = axes_to_sharding(axes, ctx)
            shape = ShapeConfig("s", S, B if kind == "prefill"
                                else decode_batch(arch), kind)
            if kind == "prefill":
                bs, b_sh, cs, c_sh = prefill_specs(cfg, shape, ctx)
                fn = (lambda p, x, c, ctx=ctx:
                      jmodel.prefill(cfg, p, x, c, ctx))
                out[kind] = cost(jax.jit(fn, in_shardings=(p_sh, b_sh,
                                                           c_sh)),
                                 ps, bs, cs)
            else:
                ts, t_sh, cs, c_sh, pos, pos_sh = decode_specs(cfg, shape,
                                                               ctx)
                fn = (lambda p, t, c, q, ctx=ctx:
                      jmodel.decode_step(cfg, p, t, c, q, ctx))
                out[kind] = cost(jax.jit(fn, in_shardings=(
                    p_sh, t_sh, c_sh, pos_sh)), ps, ts, cs, pos)
    return out


def port_mesh_costs(arch):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info
    _, tcfg = _cfgs(arch)
    out = {}
    with dryrun.fake_mesh((2, 2), ("data", "model")) as m:
        info = mesh_info(m)
        for kind in ("train", "prefill", "decode"):
            rows = decode_batch(arch) if kind == "decode" else B
            r = dryrun.count(dryrun.prepare(
                tcfg, ShapeConfig(kind, S, rows, kind), minibatch=b,
                mesh=m), info)
            out[kind] = {k: r[k] for k in ("flops", "collectives",
                                           "collective_bytes_total",
                                           "kernel_launches", "roofline")}
    out["mesh_info"] = info
    return out


# a rule overridden, an axis added: make_ctx's ``rule_overrides``
OVERRIDES = {"embed": ("data",), "cache_seq": "model", "extra": "model"}


def api_parity():
    """The reference's mesh and sharding helpers beside the port's on a
    (2, 2) mesh (the port's over a fake group of 4): ``make_mesh_for``'s
    ``mesh_info``, and for each arch of a mesh family and each kind
    ``make_ctx`` with
    ``rule_overrides`` (its rules), ``axes_to_sharding`` of the
    parameters' axes (the experts' under EP and TP, the Mamba2 blocks',
    zamba2's shared block's), ``batch_sharding``
    and ``replicated`` (as specs)
    -> {"mesh_for": [port, reference], "differ": [what differs]}."""
    import jax
    from jax.sharding import AxisType
    from repro.configs.registry import get_config, list_archs
    from repro.distributed import sharding as jsh
    from repro.launch import mesh as jmesh
    from repro.models.transformer import init_lm as jinit_lm
    from repro_torch.configs import ModelConfig
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.transformer import param_axes
    jm = jax.make_mesh((2, 2), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)

    def spec(sh):
        return json.loads(json.dumps(tuple(sh.spec)))
    out = {"differ": []}
    with dryrun.fake_group(4):
        tm = tmesh.make_mesh_for(model_parallel=2)
        out["mesh_for"] = [tmesh.mesh_info(tm),
                           jmesh.mesh_info(jmesh.make_mesh_for(4, 2))]
        for arch in list_archs():
            cfg = get_config(arch)
            if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
                continue
            tcfg = ModelConfig(**dataclasses.asdict(cfg))
            holder = []
            jax.eval_shape(lambda k: holder.append(jinit_lm(cfg, k)[1])
                           or 0, jax.random.PRNGKey(0))
            for kind in ("train", "prefill", "decode"):
                jc = jsh.make_ctx(cfg, jm, kind, rule_overrides=OVERRIDES)
                tc = tsh.make_ctx(tcfg, tm, kind, rule_overrides=OVERRIDES)
                pairs = {
                    "rules": (tc.rules, jc.rules),
                    "axes_to_sharding": (
                        tsh.axes_to_sharding(param_axes(tcfg), tc),
                        jax.tree.map(spec, jsh.axes_to_sharding(
                            holder[0], jc))),
                    "batch_sharding": (tsh.batch_sharding(tc, 3, 1),
                                       spec(jsh.batch_sharding(jc, 3, 1))),
                    "replicated": (tsh.replicated(tc),
                                   spec(jsh.replicated(jc)))}
                for what, (got, want) in pairs.items():
                    if json.loads(json.dumps(got)) != \
                            json.loads(json.dumps(want)):
                        out["differ"].append([arch, kind, what])
    return out


# ---------------------------------------------------------------------------
# the reference on one device, float32: what the four ranks are held to
# ---------------------------------------------------------------------------

def _one_device_ctx(cfg):
    """The reference's ``ShardCtx`` for its one-device run: no mesh for a
    dense case; for a MoE case the (2, 2) mesh's shape and rules with
    every sharding constraint a no-op, so that ``_auto_groups`` takes the
    mesh's dispatch groups (G and C from the global token count, as the
    partitioned program does) while the arithmetic runs on one device."""
    from repro.distributed.sharding import make_rules
    from repro.models.layers import ShardCtx
    if not cfg.num_experts:
        return ShardCtx()

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    class OneDevice(ShardCtx):
        def constrain(self, x, *logical_axes):
            return x
    return OneDevice(mesh=Mesh(), rules=make_rules(cfg, Mesh(), "train"))


class _Proxy:
    """A module whose attributes are another's but for ``over``."""
    def __init__(self, inner, **over):
        self._inner = inner
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# the list a thread's traces report the reference's MoE routes to
ROUTES = threading.local()


def _record_routes():
    """The reference MoE's ``jax.lax.top_k`` (its routing) reporting each
    call's expert ids (G, Tg, k), in program order, to the list that
    ``ROUTES.record`` holds in the tracing thread (none: no report), from
    inside the compiled program (an ordered debug callback)."""
    import jax
    from repro.models import moe as jmoe

    def top_k(logits, k):
        vals, idx = jax.lax.top_k(logits, k)
        record = getattr(ROUTES, "record", None)
        if record is not None:
            jax.debug.callback(lambda i: record.append(np.asarray(i)), idx,
                               ordered=True)
        return vals, idx
    jmoe.jax = _Proxy(jax, lax=_Proxy(jax.lax, top_k=top_k))


def _kept(eidx, cfg):
    """The reference's kept pairs (G, Tg*k) for expert ids (G, Tg, k), with
    its own capacity for the group size (``moe.py:109-120``)."""
    from repro.models.moe import capacity
    G, Tg, k = eidx.shape
    C = capacity(Tg, cfg.num_experts, k, cfg.capacity_factor)
    flat = eidx.reshape(G, Tg * k)
    oh = (flat[..., None] == np.arange(cfg.num_experts)).astype(np.int64)
    pos = np.sum((np.cumsum(oh, axis=1) - oh) * oh, axis=-1)
    return pos < C


def ref_one_device(arch, out_dir):
    import jax
    import jax.numpy as jnp
    from repro.core import engine as jengine
    from repro.core.scores import ESScores
    from repro.models import model as jmodel
    from repro.optim.adamw import OptConfig
    from repro.optim.schedule import get_schedule
    cfg, _ = _cfgs(arch, compute_dtype="float32")
    ctx = _one_device_ctx(cfg)
    routes = ROUTES.record = []
    es = jengine.ESConfig(minibatch=b, n_train=N, seq_chunk=0)
    opt = OptConfig(lr=1e-3)
    eng = jengine.ESEngine(cfg, es, opt, get_schedule("cosine", 16, 0),
                           ctx)
    rng = np.random.default_rng(5)
    s0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy(),
             "sample_ids": rng.permutation(N)[:B].astype(np.int32)}
    batch["labels"][0, 20:] = -1
    prompts = rng.integers(0, cfg.vocab_size, (SB, P)).astype(np.int32)

    def run(key, s, w, bt, pr):
        state = jengine.init_train_state(cfg, es, opt, key, B)
        state = dataclasses.replace(state, scores=ESScores(
            s=s, w=w, seen=jnp.zeros(N, jnp.int32)))
        gumbel = jax.random.gumbel(jax.random.split(state.rng)[1], (B,),
                                   jnp.float32)
        new, metrics = eng.es_step(state, bt)
        cache = jmodel.init_cache(cfg, SB, P + GEN)
        logits, cache = jmodel.prefill(cfg, state.params, {"tokens": pr},
                                       cache, ctx)
        seq = [logits]
        for i in range(GEN):
            t = jnp.argmax(seq[-1], axis=-1)[:, None].astype(jnp.int32)
            logits, cache = jmodel.decode_step(cfg, state.params, t, cache,
                                               P + i, ctx)
            seq.append(logits)
        return state.params, gumbel, new, metrics, jnp.stack(seq)

    args = (jax.random.PRNGKey(0), jnp.asarray(s0), jnp.asarray(w0),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(prompts))
    params, gumbel, new, metrics, logits = jax.device_get(
        jax.jit(run).lower(*args).compile(compiler_options=FAST)(*args))
    jax.effects_barrier()
    flat = {f"{prefix}/{k}": v.astype(np.float32)
            for prefix, tree in (("p0", params), ("p1", new.params),
                                 ("m1", new.opt.m), ("v1", new.opt.v))
            for k, v in _flatten(tree).items()}
    ROUTES.record = None
    # written whole, then renamed: the ranks start on a file when it exists
    tmp = out_dir / f"{arch}.tmp.npz"
    np.savez(tmp, s0=s0, w0=w0, gumbel=gumbel,
             prompts=prompts, logits=logits,
             **{f"routes/{i}": r for i, r in enumerate(routes)},
             **{f"kept/{i}": _kept(r, cfg) for i, r in enumerate(routes)},
             s1=np.asarray(new.scores.s), w1=np.asarray(new.scores.w),
             seen1=np.asarray(new.scores.seen),
             loss=np.float32(metrics["loss"]),
             sel_loss=np.float32(metrics["sel_loss"]),
             **{f"batch/{k}": v for k, v in batch.items()}, **flat)
    os.replace(tmp, out_dir / f"{arch}.npz")


def _refs(out_dir, arch, timeout=600):
    """The reference's one-device outputs of a case, once written."""
    import time
    path, t0 = out_dir / f"{arch}.npz", time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path.name} in {timeout} s")
        time.sleep(0.1)
    return dict(np.load(path))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _named(tree, prefix=""):
    """{path: leaf} of a nested dict, the leaves as they are."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat, prefix):
    import torch
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.ascontiguousarray(v))
    return tree


# ---------------------------------------------------------------------------
# one gloo rank: the port's sharded step and serving
# ---------------------------------------------------------------------------

def rank_main(rank, port, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core import engine as tengine
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import param_axes, tree_map
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import get_schedule
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"))
    # zamba2's "long" serving with the cache sequence over two mesh dims
    mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"))
    report = {"collectives": _collectives_ok(mesh, rank)}
    # the parts that need no reference first: it compiles meanwhile
    report["paths"] = {arch: _paths_held(mesh, arch) for arch in CASES}
    report["ckpt"] = {arch: _ckpt_held(mesh, arch, out_dir / f"ckpt_{arch}")
                      for arch in CKPT}
    # a quarter of the reference's programs on the (2, 2) mesh, compiled
    # here, beside the parent's (each process has its interpreter lock)
    for arch in list(CASES)[rank::4]:
        tmp = out_dir / f"ref_{arch}.tmp.json"
        tmp.write_text(json.dumps(ref_mesh_costs(arch)))
        os.replace(tmp, out_dir / f"ref_{arch}.json")
    for arch in CASES:
        _, cfg = _cfgs(arch, compute_dtype="float32")
        routes = []
        spy = _spy_routes(routes) if arch in MOE else None
        z = _refs(out_dir, arch)
        axes = param_axes(cfg)
        ctx = make_ctx(cfg, mesh, "train")

        def mine(tree, c=ctx):
            return tree_map(lambda t: t.contiguous().clone(),
                            shard_tree(tree, axes, c))
        es = tengine.ESConfig(minibatch=b, n_train=N)
        opt = OptConfig(lr=1e-3)
        eng = tengine.ESEngine(cfg, es, opt, get_schedule("cosine", 16, 0),
                               ctx=ctx)
        st = tengine.init_train_state(cfg, es, opt, 0, "cpu",
                                      params=mine(_unflatten(z, "p0/")),
                                      meta_batch=B, ctx=ctx)
        st.scores.s.copy_(torch.from_numpy(z["s0"]))
        st.scores.w.copy_(torch.from_numpy(z["w0"]))
        lo, n = ctx.local("batch", B)
        batch = {k: torch.from_numpy(z[f"batch/{k}"][lo:lo + n].copy())
                 for k in ("tokens", "labels", "sample_ids")}
        st, m = eng.es_step(st, batch,
                            gumbel=torch.from_numpy(z["gumbel"]))
        r = {"loss": [float(m["loss"]), float(z["loss"])],
             "sel_loss": [float(m["sel_loss"]), float(z["sel_loss"])],
             "scores": [bool(np.allclose(st.scores.s.numpy(), z["s1"],
                                         atol=ATOL, rtol=RTOL)),
                        bool(np.allclose(st.scores.w.numpy(), z["w1"],
                                         atol=ATOL, rtol=RTOL)),
                        bool((st.scores.seen.numpy() == z["seen1"]).all())]}
        bad, eps_regime, total = _state_held(
            st, [_unflatten(z, f"{p}/") for p in ("m1", "v1", "p1")],
            axes, ctx)
        r.update(bad=bad, eps_regime=eps_regime, n_weights=total)
        if arch in SSM:
            r["replicas_differ"] = _replicas_differ(st.params, ctx)
        # serving under the decode rules (llama: the cache's sequence over
        # "model"), held to the reference's prefill and decode logits
        r["logit_err"], cache = _serve_held(cfg, z, mesh, "decode")
        r["cache_shapes"] = {k: list(v.shape)
                             for k, v in _named(cache).items()}
        if cfg.family == "hybrid":
            r["long_logit_err"] = {
                str(m.mesh_dim_names): _serve_held(cfg, z, m, "long")[0]
                for m in (mesh, mesh3)}
        if spy is not None:
            spy()
            r["routes"] = _routes_held(routes, z, make_ctx(cfg, mesh))
        report[arch] = r
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def _serve_held(cfg, z, mesh, kind):
    """Prefill and GEN decode steps under ``kind``'s rules on ``mesh`` on
    the rank's rows of the prompts (every row when the rules leave the
    batch whole), fed the reference's argmax tokens -> (each call's
    largest distance to the reference's one-device logits, the cache)."""
    import torch
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_axes, tree_map
    ctx = make_ctx(cfg, mesh, kind)
    params = tree_map(lambda t: t.contiguous().clone(), shard_tree(
        _unflatten(z, "p0/"), param_axes(cfg), ctx))
    cache = tmodel.init_cache(cfg, SB, P + GEN, device="cpu", ctx=ctx)
    lo, n = ctx.local("batch", SB)
    logits, cache = tmodel.prefill(
        cfg, params, {"tokens": torch.from_numpy(
            z["prompts"][lo:lo + n].copy())}, cache, ctx)
    errs = [float(np.abs(logits.numpy() - z["logits"][0, lo:lo + n]).max())]
    pos = torch.full((1,), P, dtype=torch.long)
    for i in range(GEN):
        t = torch.from_numpy(np.argmax(z["logits"][i, lo:lo + n], axis=-1)
                             [:, None].astype(np.int32))
        logits, cache = tmodel.decode_step(cfg, params, t, cache, pos, ctx)
        errs.append(float(np.abs(logits.numpy()
                                 - z["logits"][i + 1, lo:lo + n]).max()))
        pos += 1
    return errs, cache


def _replicas_differ(params, ctx):
    """The Mamba2 leaves replicated over "model" that are not bitwise
    equal on this rank and its "model" peer after a step."""
    import torch
    bad = []
    for name, t in _named(params).items():
        if name.split("/")[-1] in SSM_REPLICATED:
            both = ctx.all_gather(t.contiguous()[None], "mlp", 0)
            if not torch.equal(both[0], both[1]):
                bad.append(name)
    return bad


def _ckpt_held(mesh, arch, ckpt_dir):
    """A model-sharded ES state (``arch``'s smoke config under FSDP, one
    step) saved from the four ranks, restored onto the same grid and onto
    one process: each restore bitwise the state it was saved from (the
    one process's: the state gathered whole), and one more step from
    each bitwise the step without the round trip; a save without the
    layout refused, naming the first split leaf -> failures."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten, unflatten
    from repro_torch.core import engine as tengine
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.transformer import init_lm, param_axes, tree_map
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import get_schedule
    _, cfg = _cfgs(arch, compute_dtype="float32", fsdp_params=True)
    es = tengine.ESConfig(minibatch=b, n_train=N)
    opt = OptConfig(lr=1e-3)
    full = init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(13)
    batches = []
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
        batches.append({"tokens": tok[:, :-1].contiguous(),
                        "labels": tok[:, 1:].contiguous(),
                        "sample_ids": torch.from_numpy(
                            rng.permutation(N)[:B].astype(np.int32))})
    bad = []

    def engine(ctx, params):
        eng = tengine.ESEngine(cfg, es, opt, get_schedule("constant", 1),
                               ctx=ctx)
        return eng, tengine.init_train_state(
            cfg, es, opt, 0, "cpu", meta_batch=B, ctx=ctx,
            params=tree_map(lambda t: t.contiguous().clone(), params))

    def copy(tree):
        return {k: v.clone() for k, v in flatten(tree).items()}

    def differ(got, want, what):
        got, want = flatten(got), flatten(want)
        bad.extend(f"{what} {k}" for k in want
                   if not torch.equal(got[k], want[k]))

    ctx = make_ctx(cfg, mesh, "train")
    lo, n = ctx.local("batch", B)
    mine = [{k: v[lo:lo + n] for k, v in bt.items()} for bt in batches]
    eng, st = engine(ctx, shard_tree(full, param_axes(cfg), ctx))
    st = eng.es_step(st, mine[0])[0]
    tree = eng.state_dict(st)
    saved = copy(tree)
    ck = Checkpointer(ckpt_dir)
    try:
        ck.save(tree, 1)
        bad.append("saved without a layout")
    except ValueError as e:
        if "params/embed/tok" not in str(e):
            bad.append(f"refusal names no leaf: {e}")
    layout = eng.checkpoint_layout()
    ck.save(tree, 1, layout=layout)
    dist.barrier()
    manifest = ck.manifest(1)["metadata"]["layout"]
    if manifest["mesh"] != {"axis_names": ["data", "model"],
                            "shape": [2, 2]} or \
            manifest["axes"]["params/embed/tok"] != ["vocab", "embed"]:
        bad.append(f"manifest {manifest['mesh']}")
    # the same grid: a fresh state's tree as the template
    eng2, st2 = engine(ctx, shard_tree(full, param_axes(cfg), ctx))
    st2 = eng2.load_state_dict(st2, ck.restore(eng2.state_dict(st2), 1,
                                               layout=layout))
    differ(eng2.state_dict(st2), saved, "grid")
    # one process: every leaf whole, the gathered state
    whole = {k: layout.gather(k, v) for k, v in saved.items()}
    eng1, st1 = engine(ShardCtx(), full)
    st1 = eng1.load_state_dict(st1, ck.restore(eng1.state_dict(st1), 1))
    differ(eng1.state_dict(st1), whole, "one process")
    # one more step from each restore, and from the states without one
    m2 = eng2.es_step(st2, mine[1])[1]
    m = eng.es_step(st, mine[1])[1]
    differ(eng2.state_dict(st2), copy(eng.state_dict(st)), "grid step")
    if float(m2["loss"]) != float(m["loss"]):
        bad.append("grid step loss")
    engw, stw = engine(ShardCtx(), full)
    stw = engw.load_state_dict(stw, unflatten(whole))
    m1 = eng1.es_step(st1, batches[1])[1]
    mw = engw.es_step(stw, batches[1])[1]
    differ(eng1.state_dict(st1), copy(engw.state_dict(stw)),
           "one-process step")
    if float(m1["loss"]) != float(mw["loss"]):
        bad.append("one-process step loss")
    return bad


def _spy_routes(record):
    """Record each port MoE call's (expert ids, kept pairs) in call order;
    -> a function that takes the spy out."""
    from repro_torch.models import moe
    inner = moe.route

    def route(logits, k, C):
        out = inner(logits, k, C)
        record.append((out[1].numpy(), out[3].numpy()))
        return out
    moe.route = route

    def undo():
        moe.route = inner
    return undo


def _routes_held(routes, z, ctx):
    """The rank's MoE calls against the reference's one-device routes:
    as many calls, and each call's expert ids and kept pairs those of the
    reference's groups this rank routed (its own G / dp groups, or the
    whole group it shares) -> failures."""
    want = sorted((k for k in z if k.startswith("routes/")),
                  key=lambda k: int(k.split("/")[1]))
    if len(routes) != len(want):
        return [f"{len(routes)} MoE calls, the reference {len(want)}"]
    bad = []
    for i, ((eidx, keep), key) in enumerate(zip(routes, want)):
        ref_e, ref_k = z[key], z[f"kept/{key.split('/')[1]}"]
        if eidx.shape[0] != ref_e.shape[0]:        # local groups
            n = eidx.shape[0]
            lo = ctx.coord("batch") * n
            ref_e, ref_k = ref_e[lo:lo + n], ref_k[lo:lo + n]
        if eidx.shape != ref_e.shape or not (eidx == ref_e).all():
            bad.append(f"expert ids {i}")
        if keep.shape != ref_k.shape or not (keep == ref_k).all():
            bad.append(f"kept {i}")
    return bad


@contextlib.contextmanager
def _mesh_groups(dp):
    """The port's one-process MoE calls group their tokens as a mesh of
    ``dp`` data ranks does (``_auto_groups`` on the global token count),
    so that they route as the mesh's; the mesh's own calls are
    untouched."""
    from repro_torch.models import moe
    real = moe._auto_groups

    def groups(ctx, T, E):
        if ctx.mesh is not None:
            return real(ctx, T, E)
        g = dp
        if T % g:
            return 1
        while g > 1 and T // g < 2 * E:
            g //= 2
        return g
    moe._auto_groups = groups
    try:
        yield
    finally:
        moe._auto_groups = real


def _paths_held(mesh, arch):
    """The engine's other entry points and the server on the mesh, each
    held to the one-process port on the same float32 weights, batches and
    seeds (``_state_held``; the selected rows and the store equal):
    ``baseline_step``; two ``scheduled_step``s at scoring period 2 (the
    second selects on the stale weights); ``prime_step``, a
    ``pipelined_step`` and a ``flush_step``; ``Server.generate`` at
    temperature 0.8; and a state that ``init_train_state(ctx)`` draws
    without parameters (``_init_held``). A MoE case's one-process calls
    take the mesh's dispatch groups (``_mesh_groups``). The SSM cases run
    ``baseline_step``, the server and the draw: a second AdamW step
    carries the first one's eps-regime weights (gradients near 1e-8,
    1.4 % of mamba2 smoke's) into the forward, and a few weights then
    leave 1e-5; the two-step paths are the engine's, held on the other
    cases."""
    with _mesh_groups(2):
        return _paths_held_grouped(mesh, arch)


def _paths_held_grouped(mesh, arch):
    import torch
    from repro_torch.core import engine as tengine
    from repro_torch.core.frequency import FreqSchedule
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.transformer import (init_lm, param_axes,
                                                tree_map)
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import get_schedule
    _, cfg = _cfgs(arch, compute_dtype="float32")
    axes = param_axes(cfg)
    ctx = make_ctx(cfg, mesh, "train")
    es = tengine.ESConfig(minibatch=b, n_train=N)
    opt = OptConfig(lr=1e-3)
    full = init_lm(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
        batches.append({"tokens": tok[:, :-1].contiguous(),
                        "labels": tok[:, 1:].contiguous(),
                        "sample_ids": torch.from_numpy(
                            rng.permutation(N)[:B].astype(np.int32))})
    lo, n = ctx.local("batch", B)
    mine = [{k: v[lo:lo + n] for k, v in bt.items()} for bt in batches]

    def pair(freq=None):
        """(engine, state) one-process and on the mesh, same weights."""
        out = []
        for c, p in ((ShardCtx(), full), (ctx, shard_tree(full, axes,
                                                            ctx))):
            eng = tengine.ESEngine(cfg, es, opt, get_schedule("constant", 1),
                                   freq=freq, ctx=c)
            st = tengine.init_train_state(
                cfg, es, opt, 0, "cpu", meta_batch=B, ctx=c,
                params=tree_map(lambda t: t.contiguous().clone(), p))
            out.append((eng, st))
        return out

    def held(one, st, steps):
        """``steps``: (one-process metrics, mesh metrics) a step."""
        bad, eps_regime, total = _state_held(
            st, [one.opt.m, one.opt.v, one.params], axes, ctx)
        for i, (m1, mm) in enumerate(steps):
            if not np.isclose(float(mm["loss"]), float(m1["loss"]),
                              rtol=1e-5):
                bad.append(f"loss {i}")
            if "selected" in m1 and not torch.equal(m1["selected"],
                                                    mm["selected"]):
                bad.append(f"selected {i}")
            if m1.get("scored") != mm.get("scored"):
                bad.append(f"scored {i}")
        for f in ("s", "w", "seen"):
            if not np.allclose(getattr(st.scores, f).numpy(),
                               getattr(one.scores, f).numpy(),
                               atol=ATOL, rtol=RTOL):
                bad.append(f"store {f}")
        return {"bad": bad, "eps_regime": eps_regime, "n_weights": total}

    res = {}
    (e1, s1), (em, sm) = pair()
    res["baseline"] = held(s1, sm, [(e1.baseline_step(s1, batches[0])[1],
                                     em.baseline_step(sm, mine[0])[1])])
    if arch not in SSM:
        (e1, s1), (em, sm) = pair(FreqSchedule(k=2))
        res["scheduled"] = held(s1, sm, [
            (e1.scheduled_step(s1, batches[i])[1],
             em.scheduled_step(sm, mine[i])[1]) for i in range(2)])
        (e1, s1), (em, sm) = pair()
        e1.prime_step(s1, batches[0])
        em.prime_step(sm, mine[0])
        res["pipelined"] = held(s1, sm, [
            (e1.pipelined_step(s1, tuple(batches))[1],
             em.pipelined_step(sm, tuple(mine))[1]),
            (e1.flush_step(s1, batches[1])[1],
             em.flush_step(sm, mine[1])[1])])
    dctx = make_ctx(cfg, mesh, "decode")
    prompts = rng.integers(0, cfg.vocab_size, (SB, P)).astype(np.int32)
    want = Server(cfg, device="cpu", params=full).generate(
        prompts, GEN, temperature=0.8, seed=3)
    local = tree_map(lambda t: t.contiguous().clone(),
                     shard_tree(full, axes, dctx))
    got = Server(cfg, device="cpu", params=local, ctx=dctx).generate(
        prompts, GEN, temperature=0.8, seed=3)
    res["server_tokens_equal"] = bool(np.array_equal(got, want))
    res["init"] = _init_held(cfg, es, opt, ctx, axes)
    return res


def _init_held(cfg, es, opt, ctx, axes):
    """A rank's state drawn by ``init_train_state(ctx)`` with no
    parameters, against the one-process draw of the same seed: each
    leaf at its local shape; a constant leaf (norm scales, biases) the
    one-process leaf's slice exactly; a random leaf's standard deviation
    within 10 % of the one-process leaf's, and equal on every rank that
    holds the same shard -> failures."""
    import torch
    from repro_torch.core import engine as tengine
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.layers import local_shape
    from repro_torch.models.transformer import init_lm
    st = tengine.init_train_state(cfg, es, opt, 5, "cpu", meta_batch=B,
                                  ctx=ctx)
    one = init_lm(cfg, torch.Generator().manual_seed(5), "cpu")
    got, whole = _named(st.params), _named(one)
    cut, ax = _named(shard_tree(one, axes, ctx)), _named(axes)
    bad = []
    for name, t in got.items():
        a, w = ax[name], whole[name]
        if tuple(t.shape) != local_shape(w.shape, a, ctx):
            bad.append(f"shape {name}")
            continue
        if bool((w == w.flatten()[0]).all()):
            if not torch.equal(t, cut[name]):
                bad.append(f"constant {name}")
            continue
        if abs(float(t.std()) / float(w.std()) - 1.0) > 0.1:
            bad.append(f"std {name}")
        # (the rank's shard coordinates, its values) of every rank
        me = torch.tensor([ctx.coord(x) for x in a], dtype=torch.float32)
        coords = ctx.all_gather(me[None], "*", 0)
        vals = ctx.all_gather(t.reshape(1, -1), "*", 0)
        for i in range(coords.shape[0]):
            for j in range(i):
                if torch.equal(coords[i], coords[j]) and \
                        not torch.equal(vals[i], vals[j]):
                    bad.append(f"replicas {name}")
    return bad


def _collectives_ok(mesh, rank):
    """The four collectives of ``ShardCtx`` over "model" (2 ranks) and
    over the flattened ("data", "model") group (4), on known tensors."""
    import torch
    from repro_torch.models.layers import ShardCtx
    ctx = ShardCtx(mesh, (("m", "model"), ("all", ("data", "model"))))
    me = torch.arange(4, dtype=torch.float32) + 10 * rank
    c = ctx.coord("m")
    peer = rank - c + (1 - c)                # the other rank on "model"
    other = torch.arange(4, dtype=torch.float32) + 10 * peer
    pair = [me, other] if c == 0 else [other, me]
    world = sum(torch.arange(4, dtype=torch.float32) + 10 * r
                for r in range(4))
    return {
        "all_reduce": bool(torch.equal(ctx.all_reduce(me, "all"), world)),
        "max": bool(torch.equal(ctx.all_reduce(me, "m", "max"),
                                torch.maximum(me, other))),
        "all_gather": bool(torch.equal(ctx.all_gather(me, "m"),
                                       torch.cat(pair))),
        "reduce_scatter": bool(torch.equal(ctx.reduce_scatter(me, "m"),
                                           (me + other)[2 * c:2 * c + 2])),
        "all_to_all": bool(torch.equal(ctx.all_to_all(me, "m"), torch.cat(
            [p[2 * c:2 * c + 2] for p in pair])))}


def _state_held(st, wants, axes, ctx):
    """The families test's rule for a rank's state after its optimizer
    steps, against ``wants`` (m, v, params, whole) cut to the rank's
    shard: m and v at ATOL / RTOL, the weights too but for those whose
    step sat within ten AdamW eps of zero (sqrt(v-hat) < 1e-7: held
    through m and v instead) -> (failures, weights exempt, weights
    held)."""
    bc2 = 1.0 - 0.95 ** st.opt.step
    bad, eps_regime, total = [], 0, 0
    for name, got, want_m, want_v, want_p in _leaves(st, wants, axes, ctx):
        for what, g_, w_ in (("m", got[0], want_m), ("v", got[1], want_v)):
            if not np.allclose(g_, w_, atol=ATOL, rtol=RTOL):
                bad.append(f"{what} {name}")
        live = (np.sqrt(want_v / bc2) >= 1e-7) | (want_v == 0)
        eps_regime += int((~live).sum())
        total += live.size
        if not np.allclose(got[2][live], want_p[live], atol=ATOL, rtol=RTOL):
            bad.append(f"param {name}")
    return bad, eps_regime, total


def _leaves(st, wants, axes, ctx):
    """(name, (m, v, param) of this rank, and the reference's m, v,
    param cut to the same shard) a leaf."""
    from repro_torch.distributed.sharding import shard_tree
    got = [_flatten(t) for t in (st.opt.m, st.opt.v, st.params)]
    cut = [_flatten(shard_tree(w, axes, ctx)) for w in wants]
    for name in got[2]:
        yield (name, [g[name].numpy() if hasattr(g[name], "numpy")
                      else g[name] for g in got],
               *(c[name].numpy() if hasattr(c[name], "numpy") else c[name]
                 for c in cut))


def main(out_dir):
    import socket
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"ref": {}, "port": {}}
    _record_routes()
    # the four ranks start with the parts that need no reference, compile
    # the reference's mesh programs (a quarter each) and take each case's
    # one-device reference once it is written; meanwhile this process
    # traces the port (one fake process group, on this thread, before the
    # reference's threads take the interpreter lock), then runs the
    # reference on one device in threads (XLA's compiler leaves the lock)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "rank", str(r),
                               str(port), str(out_dir)], env=env)
             for r in range(4)]
    try:
        for arch in CASES:
            result["port"][arch] = port_mesh_costs(arch)
        result["api"] = api_parity()
        with ThreadPoolExecutor(len(CASES)) as pool:
            list(pool.map(lambda c: ref_one_device(c, out_dir), CASES))
        rcs = [p.wait(timeout=300) for p in procs]
        if rcs == [0, 0, 0, 0]:
            result["ref"] = {c: json.loads((out_dir / f"ref_{c}.json")
                                           .read_text()) for c in CASES}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    result["rank_rcs"] = rcs
    result["ranks"] = [json.loads((out_dir / f"rank{r}.json").read_text())
                       if rc == 0 else None for r, rc in enumerate(rcs)]
    (out_dir / "result.json").write_text(json.dumps(result))


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        main(Path(sys.argv[2]))
