"""PyTorch port: model sharding over a ``DeviceMesh`` (the dense, MoE,
SSM and hybrid families), and checkpoints of a model-sharded state.

* ``make_rules`` gives the reference's rules for every arch and kind on
  the reference's (16, 16) and (2, 16, 16) meshes; ``param_axes`` is the
  reference ``init_lm``'s axes tree at full width.
* ``_auto_groups`` equals the reference's over data sizes, token counts
  and expert counts; EP falls back to TP with the reference's warning; a
  dispatch layout the port cannot produce raises, naming its rule.
* One subprocess (``_torch_mesh_child.py``, four host devices for JAX) on
  a (2, 2) ("data", "model") mesh, qwen1.5 smoke, llama3 smoke with
  ``fsdp_params=True, shard_kv_heads=False``, grok smoke (TP experts)
  with ``moe_groups`` 0 and 1 and arctic smoke (EP experts, the dense
  residual) with ``moe_groups`` 0, mamba2 smoke and zamba2 smoke, B 16,
  S 32, b 4 (a MoE decode step at batch 4: one dispatch group spanning
  both data ranks):
  - the port's fake-group trace has the reference's per-device FLOPs
    (``hlo_cost.analyze``): prefill and decode exactly; the ES step less
    the reference's one-hot einsums (2 x (B + b) / dp x S x V / m), for
    llama's replicated KV heads less the training forward's K/V
    projections that XLA splits over "model" (the scoring forward's and
    the backward's it does not), and for a Mamba2 layer less three
    reductions of the SSD backward that XLA forms as dots;
  - the port's collectives per kind equal its own count from the shapes
    (beside the reference's, which XLA places itself);
  - four gloo ranks run the port's sharded ``es_step``, ``prefill`` and
    four ``decode_step``s on their shards of the reference's float32
    parameters, batch and Gumbel noise, held to the reference's one-device
    outputs at ``test_torch_families.py``'s tolerances and exemptions;
    a MoE case's every dispatch (the expert ids and kept pairs of each
    group the rank routes) equals the reference's, whose one-device run
    groups the tokens as the mesh does; the Mamba2 leaves replicated
    over "model" stay bitwise equal over it after the step; zamba2
    serves under the "long" rules (the shared block's cache sequence
    over "data", and over ("pod", "data") on a (2, 1, 2) mesh);
  - a model-sharded ES state (qwen1.5 and mamba2 smoke under FSDP)
    saved from the four ranks restores bitwise onto the same grid and
    onto one process, one more step from each restore is bitwise the
    step without the round trip, and a save without its layout raises
    naming the leaf.
* The checkpointed cross-entropy's extra work against the reference at
  one device: the recomputed logits less the one-hot einsums, to the FLOP.
* ``xent_partials``' plain version leaves a label outside its vocabulary
  slice out of the target partial, so the split folds to the whole.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FAST, one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.configs.registry import list_archs as jlist_archs
from repro.core import engine as jengine
from repro.distributed.sharding import make_ctx as jmake_ctx
from repro.distributed.sharding import make_rules as jmake_rules
from repro.launch.hlo_cost import analyze
from repro.models import moe as jmoe
from repro.models.layers import ShardCtx
from repro.models.transformer import init_lm as jinit_lm
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import make_ctx, make_rules
from repro_torch.kernels.xent.ops import (vocab_split, xent_combine,
                                          xent_partials)
from repro_torch.kernels.xent.ref import xent_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_mesh, make_mesh_for,
                                     make_production_mesh, mesh_info)
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ShardCtx as PortShardCtx
from repro_torch.models.transformer import param_axes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KINDS = ("train", "prefill", "decode", "long")
B, S, b, DP, M = 16, 32, 4, 2, 2
ARCHS = {"qwen1.5-0.5b": {},
         "llama3-8b": {"fsdp_params": True, "shard_kv_heads": False}}
# the child's MoE cases: case -> (arch, overrides of its smoke config)
MOE = {"grok-g0": ("grok-1-314b", {"moe_groups": 0}),
       "grok-g1": ("grok-1-314b", {"moe_groups": 1}),
       "arctic-g0": ("arctic-480b", {"moe_groups": 0})}
SSM = {"mamba2-780m": ("mamba2-780m", {}), "zamba2-2.7b": ("zamba2-2.7b", {})}
CASES = {**{a: (a, over) for a, over in ARCHS.items()}, **MOE, **SSM}


class _FakeMesh:
    """The reference test's stand-in (``tests/test_sharding_dryrun.py``)."""
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


class _PortMesh:
    """The same stand-in for the port's rules, which read a
    ``DeviceMesh``'s ``mesh_dim_names`` and ``size(i)`` (and a rank's
    ``get_coordinate()``: rank 0's)."""
    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]

    def get_coordinate(self):
        return [0] * len(self._sizes)


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def test_rules_match_reference():
    """``make_rules``, and ``make_ctx``'s rules with and without
    ``rule_overrides`` (a rule replaced, an axis added)."""
    over = {"embed": ("data",), "cache_seq": "model", "extra": "model"}
    for names, sizes in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        for arch in jlist_archs():
            cfg = jget_config(arch)
            for kind in KINDS:
                # both warn alike where EP falls back to TP
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    want = jmake_rules(cfg, _FakeMesh(names, sizes), kind)
                    got = make_rules(_tcfg(cfg), _PortMesh(names, sizes),
                                     kind)
                    assert got == want, (arch, kind, names)
                    for ov in (None, over):
                        assert make_ctx(
                            _tcfg(cfg), _PortMesh(names, sizes), kind,
                            ov).rules == jmake_ctx(
                            cfg, _FakeMesh(names, sizes), kind, ov).rules, \
                            (arch, kind, names, ov)


def test_meshes_over_the_default_group():
    """The reference's production meshes over fake groups of 256 and
    512; ``make_mesh_for`` from the group's size; the errors."""
    with dryrun.fake_group(256):
        assert mesh_info(make_production_mesh()) == {
            "axis_names": ["data", "model"], "shape": [16, 16],
            "n_devices": 256}
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True)
    with dryrun.fake_group(512):
        assert mesh_info(make_production_mesh(multi_pod=True)) == {
            "axis_names": ["pod", "data", "model"], "shape": [2, 16, 16],
            "n_devices": 512}
    with dryrun.fake_group(8):
        assert mesh_info(make_mesh_for(model_parallel=2)) == {
            "axis_names": ["data", "model"], "shape": [4, 2],
            "n_devices": 8}
    with pytest.raises(ValueError):
        make_mesh_for(6, 4)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh((2, 2), ("data", "model"))


def _axes_tree(x):
    if isinstance(x, dict):
        return {k: _axes_tree(v) for k, v in x.items()}
    return tuple(x) if x is not None else None


def test_param_axes_match_reference_init_lm():
    for arch in jlist_archs():
        cfg = jget_config(arch)
        holder = []
        jax.eval_shape(lambda k: holder.append(jinit_lm(cfg, k)[1]) or 0,
                       jax.random.PRNGKey(0))
        assert param_axes(_tcfg(cfg)) == _axes_tree(holder[0]), arch


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(HERE / "_torch_mesh_child.py"),
                        "main", str(out)], capture_output=True, text=True,
                       timeout=400, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((out / "result.json").read_text())


def _onehot(cfg):
    """The reference's one-hot einsums a device: 2 x rows x S x V / m
    over the B / dp scored and b / dp trained rows."""
    return 2 * (B + b) // DP * S * cfg.vocab_size // M


def _kv_split(cfg):
    """The training forward's K/V projections XLA splits over "model"
    when KV heads are replicated: (1 - 1 / m) of them, a layer."""
    if cfg.family == "ssm" or (cfg.shard_kv_heads
                               and cfg.num_kv_heads % M == 0):
        return 0
    kv = cfg.num_kv_heads * cfg.resolved_head_dim()
    return cfg.num_layers * 2 * (2 * b // DP * S * cfg.d_model * kv) \
        * (M - 1) // M


def _ssd_backward(cfg):
    """The SSD backward's reductions that XLA forms as dots (batched over
    every other dimension) and the port as a product and a sum, a device:
    the gradients of the two decay factors (``decay_states``,
    ``state_decay``: a sum over the head dim P) and of C B^T (a sum over
    the heads), 2 x (2 x H_l x P + H_l x chunk) a trained token, a
    Mamba2 layer."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    hl = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // M
    return cfg.num_layers * 2 * (b // DP * S) * (
        2 * hl * cfg.ssm_head_dim + hl * cfg.ssm_chunk)


def _attn_layers(cfg):
    """The self-attention layers a forward runs (a flash launch each on
    the card's route)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def test_mesh_flops_match_reference(mesh_run):
    for arch, (name, over) in CASES.items():
        cfg = dataclasses.replace(jget_smoke_config(name), **over)
        ref, port = mesh_run["ref"][arch], mesh_run["port"][arch]
        assert port["mesh_info"] == {"axis_names": ["data", "model"],
                                     "shape": [2, 2], "n_devices": 4}
        assert port["prefill"]["flops"] == ref["prefill"]["flops"], arch
        assert port["decode"]["flops"] == ref["decode"]["flops"], arch
        assert port["train"]["flops"] == (
            ref["train"]["flops"] - _onehot(cfg) + _kv_split(cfg)
            - _ssd_backward(cfg)), \
            (arch, port["train"]["flops"], ref["train"]["flops"])
        flash = {"flash_attn": _attn_layers(cfg)} if _attn_layers(cfg) \
            else {}
        assert port["train"]["kernel_launches"] == {
            **flash, "xent_partials": 1, "xent_combine": 1,
            "score_update": 1}
        assert port["prefill"]["kernel_launches"] == flash
    q = mesh_run["ref"]["qwen1.5-0.5b"]["train"]["flops"]
    assert q == 59_719_680          # 1/4 of the one-device 238,878,720


def _leaf_bytes(cfg):
    """Each parameter leaf's bytes (float32) after the model axis cuts
    it, whole over the data axes: (per layer, the others)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim()
    q, kv = cfg.num_heads * hd // M, cfg.num_kv_heads * hd
    if cfg.shard_kv_heads and cfg.num_kv_heads % M == 0:
        kv //= M
    layer = [d, d, d * q, d * kv, d * kv, q * d, d * f // M, d * f // M,
             f // M * d]
    if cfg.qkv_bias:
        layer += [q, kv, kv]
    top = [cfg.vocab_size // M * d, d]
    if not cfg.tie_embeddings:
        top.append(d * cfg.vocab_size // M)
    return [4 * n for n in layer], [4 * n for n in top]


def _expected_collectives(cfg, kind):
    """The port's collectives a device, from the shapes: {kind: (count,
    bytes)}."""
    cb = 2                                       # bfloat16 activations
    d, L, hd = cfg.d_model, cfg.num_layers, cfg.resolved_head_dim()
    V = cfg.vocab_size
    fsdp = cfg.fsdp_params
    kv_rep = not (cfg.shard_kv_heads and cfg.num_kv_heads % M == 0)
    per_layer, top = _leaf_bytes(cfg)
    n_leaves = L * len(per_layer) + len(top)
    gathered = L * sum(per_layer) + sum(top)     # one forward's FSDP gathers
    out = {"all-reduce": [0, 0], "all-gather": [0, 0],
           "reduce-scatter": [0, 0]}

    def add(k, n, nbytes):
        out[k][0] += n
        out[k][1] += n * nbytes

    def forward(rows, seq):
        """The embedding's and each layer's two partial sums; under FSDP
        every leaf gathered once."""
        add("all-reduce", 1 + 2 * L, rows * seq * d * cb)
        if fsdp:
            out["all-gather"][0] += n_leaves
            out["all-gather"][1] += gathered
    if kind == "train":
        Bl, bl = B // DP, b // DP
        forward(Bl, S)                                   # scoring
        n_split = vocab_split(Bl * S, V // M, 132)[0]
        add("all-gather", 1, Bl * S * n_split * M * 3 * 4)   # partials
        add("all-gather", 2, B * 4)                      # losses, ids
        add("all-gather", 2, B * S * 4)                  # tokens, labels
        add("all-gather", 1, B * 4)                      # sample ids
        forward(bl, S)                                   # training
        add("all-reduce", 3, bl * S * 4)                 # max, sum, target
        add("all-reduce", 2 * L + 1, bl * S * d * cb)    # the enters' grads
        if kv_rep:                                       # wk, wv grads
            add("all-reduce", 2 * L, per_layer[3])
        if fsdp:                                         # gathers' grads
            out["reduce-scatter"] = [n_leaves, gathered // DP]
        else:                           # data-parallel sum, a stacked leaf
            out["all-reduce"][0] += len(per_layer) + len(top)
            out["all-reduce"][1] += gathered
        add("all-reduce", 2, 4)                          # norm, loss
    else:
        Bl = B // DP
        seq = S if kind == "prefill" else 1
        forward(Bl, seq)
        add("all-gather", 1, Bl * V * 4)                 # the logits
        if kind == "decode" and kv_rep:
            H, K = cfg.num_heads, cfg.num_kv_heads
            add("all-gather", 2 * L, Bl * K * hd * cb)   # split K/V
            add("all-gather", L, Bl * H * hd * cb)       # every query head
            add("all-gather", L, M * Bl * H * (hd + 2) * 4)  # partials
    return {k: {"count": c, "bytes": n} for k, (c, n) in out.items() if c}


def test_mesh_collectives_counted_from_shapes(mesh_run):
    for arch, over in ARCHS.items():
        cfg = dataclasses.replace(jget_smoke_config(arch), **over)
        for kind in ("train", "prefill", "decode"):
            port = mesh_run["port"][arch][kind]
            want = _expected_collectives(cfg, kind)
            assert port["collectives"] == want, (arch, kind, port, want)
            assert port["collective_bytes_total"] == sum(
                v["bytes"] for v in want.values())
            assert port["roofline"]["collective_s"] > 0
            # the reference's, beside: XLA places its own collectives
            assert mesh_run["ref"][arch][kind]["collectives"], (arch, kind)


def test_four_gloo_ranks_match_reference(mesh_run):
    assert mesh_run["rank_rcs"] == [0, 0, 0, 0]
    for rank, report in enumerate(mesh_run["ranks"]):
        assert all(report["collectives"].values()), rank
        for arch in CASES:
            r = report[arch]
            where = f"rank {rank} {arch}"
            np.testing.assert_allclose(*r["loss"], rtol=1e-5, err_msg=where)
            np.testing.assert_allclose(*r["sel_loss"], rtol=1e-5,
                                       err_msg=where)
            assert r["scores"] == [True, True, True], where
            assert r["bad"] == [], where
            assert r["eps_regime"] <= r["n_weights"] // 50, where
            assert max(r["logit_err"]) < 1e-4, (where, r["logit_err"])
            if arch in MOE:
                assert r["routes"] == [], (where, r["routes"])
            if arch in SSM:
                assert r["replicas_differ"] == [], (where,
                                                    r["replicas_differ"])
        # llama decodes from a cache whose sequence is split over "model"
        shapes = {a: report[a]["cache_shapes"] for a in CASES}
        assert shapes["llama3-8b"]["kv/k"][2] == (S // 2 + 4) // M
        assert shapes["qwen1.5-0.5b"]["kv/k"][3] == 4 // M
        # an SSM cache: heads and inner channels over "mlp", B/C whole
        nh = 8                                     # 128 inner / 16
        for a in SSM:
            assert shapes[a]["ssm/ssm_state"][-3] == nh // M, a
            assert shapes[a]["ssm/conv_x"][-1] == 128 // M, a
            assert shapes[a]["ssm/conv_bc"][-1] == 32, a
        assert shapes["zamba2-2.7b"]["attn_kv/k"][-2] == 4 // M
        # zamba2 at long_500k's rules: every row on every rank, its shared
        # block's cache sequence over "data", or over ("pod", "data")
        for mesh, errs in report["zamba2-2.7b"]["long_logit_err"].items():
            assert max(errs) < 1e-4, (rank, mesh, errs)


def test_four_gloo_ranks_run_the_other_paths(mesh_run):
    """``baseline_step``, ``scheduled_step`` (a stale leg), prime +
    ``pipelined_step`` + flush, ``Server.generate`` at temperature 0.8
    and a parameterless ``init_train_state(ctx)`` on the mesh, each held
    to the one-process port (float32, the families test's rule); the SSM
    cases' two-step paths are not held elementwise (their first step's
    eps-regime weights move the second step's forward)."""
    assert mesh_run["rank_rcs"] == [0, 0, 0, 0]
    for rank, report in enumerate(mesh_run["ranks"]):
        assert set(report["paths"]) == set(CASES)
        for arch, r in report["paths"].items():
            where = f"rank {rank} {arch}"
            paths = ("baseline",) if arch in SSM else (
                "baseline", "scheduled", "pipelined")
            assert set(r) == {*paths, "server_tokens_equal", "init"}, where
            for path in paths:
                assert r[path]["bad"] == [], (where, path, r[path]["bad"])
                assert r[path]["eps_regime"] <= r[path]["n_weights"] // 50, \
                    (where, path)
            assert r["server_tokens_equal"], where
            assert r["init"] == [], (where, r["init"])


def test_model_sharded_checkpoint_round_trips(mesh_run):
    """qwen1.5 and mamba2 smoke under FSDP, one ES step on the (2, 2)
    mesh: saved from the four ranks (each split leaf gathered whole),
    restored onto the same grid and onto one process bitwise, one more
    step from each restore bitwise the step without the round trip; a
    save without the layout refused, naming ``params/embed/tok``."""
    assert mesh_run["rank_rcs"] == [0, 0, 0, 0]
    for rank, report in enumerate(mesh_run["ranks"]):
        assert set(report["ckpt"]) == {"qwen1.5-0.5b", "mamba2-780m"}
        for arch, bad in report["ckpt"].items():
            assert bad == [], (rank, arch, bad)


def test_sharding_helpers_match_reference(mesh_run):
    """``make_mesh_for``, ``make_ctx(rule_overrides)``,
    ``axes_to_sharding``, ``batch_sharding`` and ``replicated`` against
    the reference's on a (2, 2) mesh, every arch of a mesh family (dense,
    MoE, SSM, hybrid) and kind."""
    api = mesh_run["api"]
    assert api["mesh_for"][0] == api["mesh_for"][1] == {
        "axis_names": ["data", "model"], "shape": [2, 2], "n_devices": 4}
    assert api["differ"] == []


def test_run_cell_on_an_explicit_mesh_and_refusals():
    res = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "kv_replicate",
                          mesh="2x2", mesh_shape=(2, 2))
    assert res["mesh_info"] == {"axis_names": ["data", "model"],
                                "shape": [2, 2], "n_devices": 4}
    assert res["flops"] > 0 and res["collective_bytes_total"] > 0
    assert set(res["collectives"]) == {"all-reduce", "all-gather"}
    assert res["roofline"]["collective_s"] > 0
    # grok-1 on the reference's 16 x 16 mesh under the paper's global
    # dispatch: every layer's tokens gathered over "data", the capacity
    # split over it, the experts' d_ff over "model"
    moe = dryrun.run_cell("grok-1-314b", "prefill_32k", "es_ungrouped",
                          mesh="single")
    assert moe["mesh_info"]["shape"] == [16, 16]
    assert moe["flops"] > 0 and moe["kernel_launches"] == {"flash_attn": 64}
    assert moe["collectives"]["all-gather"]["count"] > 64
    assert "does not split evenly: heads 56 over model 16" in dryrun.run_cell(
        "arctic-480b", "train_4k", "moe_grouped_ep", mesh="multi")["refused"]
    # the SSM and hybrid families at long_500k's rules: mamba2's SSD
    # heads over "model" on 16 x 16; zamba2 on 2 x 16 x 16, its shared
    # block's cache sequence over ("pod", "data"), the partial softmaxes
    # all-gathered over that flattened group
    for arch, mesh in (("mamba2-780m", "single"), ("zamba2-2.7b", "multi")):
        got = dryrun.run_cell(arch, "long_500k", "es", mesh=mesh)
        assert "refused" not in got and got["flops"] > 0, (arch, got)
        assert got["kernel_launches"] == {}, arch      # decode: no kernel
        assert got["collectives"]["all-reduce"]["count"] > 0, arch
    assert got["mesh_info"]["shape"] == [2, 16, 16]
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        got = dryrun.run_cell(arch, "train_4k", "es", mesh="single")
        assert "vlm and encdec" in got["refused"] and \
            "later slice" in got["refused"]
    assert "shards no model" in dryrun.run_cell(
        "llama3-8b", "train_4k", "kv_shard")["refused"]
    assert "shards no model" in dryrun.run_cell(
        "grok-1-314b", "decode_32k", "moe_tp")["refused"]


def _port_ctx(names, sizes, cfg, kind="train"):
    """The port's ``ShardCtx`` of ``cfg``'s rules on a mesh stand-in."""
    mesh = _PortMesh(names, sizes)
    return PortShardCtx(mesh=mesh, rules=make_rules(cfg, mesh, kind))


def test_auto_groups_matches_reference():
    """The dispatch groups of a decode step (T = the batch) and a
    prefill or training forward, on meshes of 1 to 32 data ranks, for
    experts 4 to 128, with no mesh too."""
    assert tmoe._auto_groups(PortShardCtx(), 4096, 8) == \
        jmoe._auto_groups(ShardCtx(), 4096, 8) == 1
    seen = set()
    for names, sizes in ((("data", "model"), (1, 2)),
                         (("data", "model"), (2, 2)),
                         (("data", "model"), (4, 1)),
                         (("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        for arch in ("grok-1-314b", "arctic-480b"):
            cfg = jget_config(arch)
            for kind in ("train", "decode", "long"):
                jctx = jmake_ctx(cfg, _FakeMesh(names, sizes), kind)
                tctx = _port_ctx(names, sizes, _tcfg(cfg), kind)
                for T in (1, 4, 8, 12, 16, 64, 128, 256, 4096, 65536,
                          1 << 20):
                    for E in (4, 8, 128):
                        got = tmoe._auto_groups(tctx, T, E)
                        assert got == jmoe._auto_groups(jctx, T, E), \
                            (names, sizes, kind, T, E)
                        seen.add(got)
    assert seen == {1, 2, 4, 8, 16, 32}


def test_ep_falls_back_to_tp_with_the_reference_warning():
    """EP needs E >= |model|: grok-1's 8 experts on a 16-way model axis
    (``moe_ep``) fall back to TP, with the reference's warning."""
    cfg = dataclasses.replace(jget_config("grok-1-314b"), moe_sharding="ep")
    mesh = (("data", "model"), (16, 16))
    with pytest.warns(UserWarning) as want:
        jrules = jmake_rules(cfg, _FakeMesh(*mesh))
    with pytest.warns(UserWarning, match="falling back to TP") as got:
        trules = make_rules(_tcfg(cfg), _PortMesh(*mesh))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert trules == jrules
    rules = dict(trules)
    assert rules["expert"] is None and rules["moe_mlp"] == "model"
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # arctic's 128 >= 16: EP
        arctic = dict(make_rules(_tcfg(jget_config("arctic-480b")),
                                 _PortMesh(*mesh)))
    assert arctic["expert"] == "model" and arctic["moe_mlp"] is None


def test_moe_layouts_the_port_cannot_produce_raise():
    """A rule the dispatch cannot follow raises, naming the rule, rather
    than replicating the work: 3 groups over 2 data ranks, a capacity
    split over an axis that is not the batch's, a capacity that does not
    split evenly."""
    cfg = _tcfg(dataclasses.replace(jget_smoke_config("grok-1-314b"),
                                    moe_groups=1))
    ctx = _port_ctx(("data", "model"), (2, 2), cfg)
    assert tmoe._placement(ctx, 2) == (1, 1)
    assert tmoe._placement(ctx, 1) == (1, 2)
    with pytest.raises(NotImplementedError, match="'expert_group': 3"):
        tmoe._placement(ctx, 3)
    odd = PortShardCtx(mesh=ctx.mesh, rules=tuple(
        (k, "model" if k == "expert_cap" else v) for k, v in ctx.rules))
    with pytest.raises(NotImplementedError, match="'expert_cap'"):
        tmoe._placement(odd, 1)
    wide = _port_ctx(("data", "model"), (8, 1), cfg)
    with pytest.raises(ValueError, match="'expert_cap': 12 does not split"):
        wide.local("expert_cap", 12)


def test_checkpointed_xent_flop_gap():
    """qwen1.5 smoke, remat "selective", S 64, seq_chunk 32: the port's
    count less the reference's is the training cross-entropy's logits,
    recomputed in the backward, less the reference's one-hot einsums."""
    S2, chunk = 64, 32
    jcfg = dataclasses.replace(jget_smoke_config("qwen1.5-0.5b"),
                               remat_policy="selective")
    es = jengine.ESConfig(minibatch=b, n_train=64, seq_chunk=chunk)
    opt = OptConfig()
    steps = jengine.ESEngine(jcfg, es, opt, get_schedule("constant", 1),
                             ShardCtx()).make_steps()
    state = jax.eval_shape(
        lambda k: jengine.init_train_state(jcfg, es, opt, k, B),
        jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((B, S2), jnp.int32)
    batch = {"tokens": tok, "labels": tok,
             "sample_ids": jax.ShapeDtypeStruct((B,), jnp.int32)}
    ref = analyze(jax.jit(steps["es_step"]).lower(state, batch).compile(
        compiler_options=FAST).as_text())["flops"]
    got = dryrun.count(dryrun.prepare(
        _tcfg(jcfg), ShapeConfig("train", S2, B, "train"),
        dryrun.Variant(es_replace=(("seq_chunk", chunk),)),
        minibatch=b))["flops"]
    V, d = jcfg.vocab_size, jcfg.d_model
    assert got - ref == 2 * b * S2 * d * V - 2 * (B + b) * S2 * V


def test_xent_partials_leave_out_labels_outside_the_slice():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(24, 32, generator=g)
    w = torch.randn(96, 32, generator=g)
    labels = torch.randint(0, 96, (24,), generator=g).to(torch.int32)
    labels[:3] = torch.tensor([0, 47, 95], dtype=torch.int32)
    want = xent_ref(h, w, labels)
    parts = []
    for lo in (0, 48):                    # two ranks' slices of 48 rows
        local = labels - lo               # negative, or >= 48, elsewhere
        p = xent_partials(h, w[lo:lo + 48], local, 16)
        outside = (local < 0) | (local >= 48)
        assert outside.any() and (p[outside][..., 2] == 0).all()
        parts.append(p)
    got = xent_combine(torch.cat(parts, dim=1))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
