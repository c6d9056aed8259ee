"""PyTorch port: the training path's three memory knobs against the JAX
package, on qwen1.5 smoke at float32 (inputs from numpy, parameters carried
across with ``bridge``).

* query-chunked attention (``attn_chunk_q`` = 16 of S = 64) against JAX's
  ``mha`` at the same chunk, causal and on packed rows: 1e-5 (the float32
  tolerance of the port's attention tests);
* sequence-chunked ``per_sample_xent`` and ``per_segment_xent``
  (``seq_chunk`` = 16) against JAX's at the same chunk: 1e-5, counts exact;
* the training loss and parameter gradients under each ``remat_policy``
  (with both chunkings on) against ``jax.grad`` of JAX's
  ``lm_per_sample_loss`` under the same policy: 1e-4 (atol and rtol, the
  float32 tolerance of ``test_torch_model.py``);
* the three policies against each other, also on packed rows (the
  per-document loss): bitwise on the CPU;
* the selective policy's op set: the projections' products (mm, addmm)
  are saved and not run again in the backward, the attention's batched
  products (bmm) and the softmax are recomputed, and "full" runs the
  projections again.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import fast_jit, one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config
from repro.models.attention import mha as jax_mha
from repro.models.layers import ShardCtx
from repro.models.losses import per_sample_xent as jax_per_sample_xent
from repro.models.losses import per_segment_xent as jax_per_segment_xent
from repro.models.transformer import init_lm
from repro.models.transformer import lm_per_sample_loss as jax_lm_loss
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core.engine import _value_and_grad
from repro_torch.data.packed import PackedSource
from repro_torch.models import transformer as ttransformer
from repro_torch.models.attention import mha
from repro_torch.models.losses import per_sample_xent, per_segment_xent

S, CHUNK = 64, 16
POLICIES = ("none", "selective", "full")


def _cfg(policy="none", chunk_q=CHUNK):
    return dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                               compute_dtype="float32",
                               remat_policy=policy, attn_chunk_q=chunk_q)


def _jax_params(cfg):
    params, _ = init_lm(cfg, jax.random.PRNGKey(3))
    return jax.device_get(params)


def _lm_batch(B=3, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)],
                            axis=1).astype(np.int32)
    labels[0, S // 2:] = -1
    return {"tokens": tokens, "labels": labels}


def _packed_rows(B=3):
    src = PackedSource.synthetic(24, S, max_segments=4, seed=1)
    return src.batch(np.arange(B))


@pytest.mark.parametrize("packed", [False, True])
def test_chunked_attention_matches_jax(packed):
    cfg = _cfg()
    layer0 = {k: np.array(v[0])
              for k, v in _jax_params(cfg)["layers"]["attn"].items()}
    rng = np.random.default_rng(4)
    B = 3
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta)
    extra = {}
    if packed:
        rows = _packed_rows(B)
        extra = {"positions": rows["positions"],
                 "segment_ids": rows["segment_ids"]}
    want = fast_jit(lambda p, xx, e: jax_mha(p, xx, ctx=ShardCtx(),
                                            chunk_q=CHUNK, **e, **kw))(
        {k: jnp.asarray(v) for k, v in layer0.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in extra.items()})
    tp = {k: torch.from_numpy(v) for k, v in layer0.items()}
    te = {k: torch.from_numpy(v) for k, v in extra.items()}
    got = mha(tp, torch.from_numpy(x), chunk_q=CHUNK, **te, **kw)
    whole = mha(tp, torch.from_numpy(x), chunk_q=0, **te, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)


def _xent_inputs(seed=2, B=4, d=32, V=128):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.1).astype(np.float32)
    seg = rng.integers(0, 5, (B, S)).astype(np.int32)
    labels = np.where(seg == 0, -1, rng.integers(0, V, (B, S))).astype(
        np.int32)
    return h, w, seg, labels


@pytest.mark.parametrize("form", ["per_sample", "per_segment"])
def test_chunked_xent_matches_jax(form):
    h, w, seg, labels = _xent_inputs()
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    tl, ts = torch.from_numpy(labels), torch.from_numpy(seg)
    jh, jw, jl, js = map(jnp.asarray, (h, w, labels, seg))
    if form == "per_sample":
        got, got_mean = per_sample_xent(th, tw, tl, seq_chunk=CHUNK)
        want, want_mean = fast_jit(lambda *a: jax_per_sample_xent(
            *a, ctx=ShardCtx(), seq_chunk=CHUNK))(jh, jw, jl)
        np.testing.assert_allclose(float(got_mean), float(want_mean),
                                   atol=1e-5)
    else:
        got, counts = per_segment_xent(th, tw, tl, ts, max_segments=4,
                                       seq_chunk=CHUNK)
        want, want_c = fast_jit(lambda *a: jax_per_segment_xent(
            *a, max_segments=4, ctx=ShardCtx(), seq_chunk=CHUNK))(
                jh, jw, jl, js)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _port_loss_and_grads(cfg, jparams, batch):
    params = params_from_jax(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = _value_and_grad(params, lambda: (
        ttransformer.lm_per_sample_loss(ModelConfig(**dataclasses.asdict(
            cfg)), params, tb, seq_chunk=CHUNK)[1], None))
    return loss, _flat(params_to_numpy(grads))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_loss_and_grads_match_jax(policy):
    cfg = _cfg(policy)
    jparams = _jax_params(cfg)
    batch = _lm_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_g = fast_jit(jax.value_and_grad(lambda p: jax_lm_loss(
        cfg, p, jb, ShardCtx(), seq_chunk=CHUNK)[1]))(jparams)
    loss, grads = _port_loss_and_grads(cfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4,
                               rtol=1e-4)
    want = _flat(jax.device_get(want_g))
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def _port_packed_loss_and_grads(cfg, jparams, rows):
    params = params_from_jax(jparams)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in rows.items()}
    loss, _, grads = _value_and_grad(params, lambda: (
        ttransformer.lm_per_segment_loss(ModelConfig(**dataclasses.asdict(
            cfg)), params, tb, seq_chunk=CHUNK)[0].sum(), None))
    return loss, _flat(params_to_numpy(grads))


@pytest.mark.parametrize("packed", [False, True])
def test_remat_policies_bitwise_equal(packed):
    jparams = _jax_params(_cfg())
    if packed:      # segment ids and positions enter each remat'd layer
        rows = _packed_rows()
        runs = [_port_packed_loss_and_grads(_cfg(p), jparams, rows)
                for p in POLICIES]
    else:
        batch = _lm_batch(seed=1)
        runs = [_port_loss_and_grads(_cfg(p), jparams, batch)
                for p in POLICIES]
    for loss, grads in runs[1:]:
        assert float(loss) == float(runs[0][0])
        for k, g in runs[0][1].items():
            np.testing.assert_array_equal(grads[k], g, err_msg=k)
    with pytest.raises(ValueError):
        _port_loss_and_grads(_cfg("offload"), jparams, _lm_batch())


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_selective_policy_saves_the_projections():
    aten = torch.ops.aten
    assert set(ttransformer.SAVED_OPS) == {aten.mm.default,
                                           aten.addmm.default}
    base = _cfg(chunk_q=0)
    params = params_from_jax(_jax_params(base))
    leaves = ttransformer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch().items()}
    L = base.num_layers
    backward = {}
    for policy in POLICIES:
        cfg = ModelConfig(**dataclasses.asdict(
            dataclasses.replace(base, remat_policy=policy)))
        with _OpCount() as fwd:
            _, mean = ttransformer.lm_per_sample_loss(cfg, params, batch,
                                                      seq_chunk=0)
        # the training forward's products: 7 projections a layer and the
        # unembedding through mm, the attention's two einsums through bmm
        products = {op: n for op, n in fwd.ops.items()
                    if "mm" in op.__name__ or "matmul" in op.__name__}
        assert products == {aten.mm.default: 7 * L + 1,
                            aten.bmm.default: 2 * L}, products
        with _OpCount() as bwd:
            torch.autograd.grad(mean, leaves)
        backward[policy] = bwd.ops
    none, sel, full = (backward[p] for p in POLICIES)
    assert sel[aten.mm.default] == none[aten.mm.default]
    assert sel[aten.bmm.default] == none[aten.bmm.default] + 2 * L
    assert sel.get(aten._softmax.default, 0) == L
    assert none.get(aten._softmax.default, 0) == 0
    # "full" runs the projections again but the last one (the MLP's down
    # projection, whose output no backward reads)
    assert full[aten.mm.default] == none[aten.mm.default] + 6 * L
