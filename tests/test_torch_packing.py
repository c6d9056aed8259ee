"""PyTorch port: packed, token-level ES against the JAX package.

Held against JAX on the same numpy inputs:

* ``PackedSource``: the port's copy builds arrays equal to JAX's, before
  and after ``set_kept_docs`` (exact);
* ``segment_causal_mask``: equal to JAX's (exact);
* the segment-sum plain version against JAX's oracle and the Pallas kernel
  in interpret mode, ragged B and S included: counts exact, sums 1e-6;
* ``per_segment_xent`` in float32 against JAX's: 1e-5;
* one ``packed_step`` with JAX's Gumbel noise injected, qwen1.5 smoke in
  float32: the kept mask and ``seen`` exact; ``s``, ``w`` and the
  parameters after AdamW within 1e-5 (rtol 1e-4), the es_step test's.

Held within the port:

* packed rows against exploded rows (each document alone at the same
  offsets) within 1e-6: JAX's own bit-equality test misses by one ulp
  (4.8e-7) on a CPU, so no bit-equality is claimed here;
* the packed step at M = 1 against ``es_step`` over 3 steps (SGD with
  momentum, rtol 1e-4 / atol 1e-5 as in the reference's test);
* the segment-sum ``autograd.Function`` backward against plain autograd
  through the plain version (exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config
from repro.core.engine import ESConfig, ESEngine, init_train_state
from repro.core.scores import ESScores
from repro.core.scores import weights_from_prev as jax_weights
from repro.core.selection import masked_select_kept as masked_select_kept_jax
from repro.data.pipeline import PackedSource as JaxPackedSource
from repro.kernels.segsum.ops import segment_sum_fused
from repro.kernels.segsum.ref import segment_sum_ref as jax_segsum_ref
from repro.models.attention import segment_causal_mask as jax_seg_mask
from repro.models.layers import ShardCtx
from repro.models.losses import per_segment_xent as jax_per_segment_xent
from repro.models.transformer import \
    lm_per_segment_loss as lm_per_segment_loss_jax
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import engine as tengine
from repro_torch.data.packed import PackedSource
from repro_torch.kernels.segsum.ops import segment_sum, segment_sum_autograd
from repro_torch.kernels.segsum.ref import segment_sum_ref
from repro_torch.models.attention import segment_causal_mask
from repro_torch.models.losses import per_segment_xent
from repro_torch.models.transformer import lm_per_segment_loss
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.optim.schedule import get_schedule as t_get_schedule


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _torch_batch(host):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in host.items()}


# ---------------------------------------------------------------------------
# data and mask
# ---------------------------------------------------------------------------

def test_packed_source_matches_jax():
    S, M, n = 32, 4, 48
    ours = PackedSource.synthetic(n, S, max_segments=M, seed=3)
    ref = JaxPackedSource.synthetic(n, S, max_segments=M, seed=3)
    assert (len(ours), ours.n_docs) == (len(ref), ref.n_docs)
    assert ours.pack_factor == ref.pack_factor
    assert ours.padding_waste == ref.padding_waste
    rows = np.arange(len(ref))[::-1]
    kept = np.arange(n) % 3 != 0
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)
    live = []
    for _ in range(2):
        got, want = ours.batch(rows), ref.batch(rows)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        live.append(int((got["doc_ids"] >= 0).sum()))
        ours.set_kept_docs(kept, scale)
        ref.set_kept_docs(kept, scale)
    assert live == [n, int(kept.sum())]
    with pytest.raises(ValueError):
        PackedSource([np.arange(40, dtype=np.int32)], seq_len=32)


def test_segment_causal_mask_matches_jax():
    src = JaxPackedSource.synthetic(24, 32, max_segments=4, seed=1)
    b = src.batch(np.arange(3))
    got = segment_causal_mask(*(torch.from_numpy(b[k]) for k in
                                ("positions", "positions", "segment_ids",
                                 "segment_ids")))
    want = jax_seg_mask(*(jnp.asarray(b[k]) for k in
                          ("positions", "positions", "segment_ids",
                           "segment_ids")))
    assert got.shape == (3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# segment sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,M", [(8, 128, 4), (5, 100, 3), (7, 300, 5),
                                   (3, 130, 1)])
def test_segsum_plain_matches_pallas_and_oracle(B, S, M):
    """Ragged B (block 8) and S (128 lanes) included."""
    rng = np.random.default_rng(B * S + M)
    nll = np.abs(rng.normal(size=(B, S))).astype(np.float32)
    seg = rng.integers(0, M + 2, (B, S)).astype(np.int32)   # M+1: no slot
    mask = rng.random((B, S)) < 0.8
    sums, counts = segment_sum(torch.from_numpy(nll), torch.from_numpy(seg),
                               torch.from_numpy(mask), max_segments=M)
    kern = segment_sum_fused(jnp.asarray(nll), jnp.asarray(seg),
                             jnp.asarray(mask), max_segments=M,
                             interpret=True)
    oracle = jax_segsum_ref(jnp.asarray(nll), jnp.asarray(seg),
                            jnp.asarray(mask), max_segments=M)
    assert sums.shape == counts.shape == (B, M)
    for ks, kc in (kern, oracle):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(kc))
        np.testing.assert_allclose(sums.numpy(), np.asarray(ks), rtol=1e-6,
                                   atol=1e-6)


def test_segsum_backward_matches_plain_autograd():
    rng = np.random.default_rng(4)
    B, S, M = 4, 40, 3
    nll0 = torch.from_numpy(np.abs(rng.normal(size=(B, S))).astype(
        np.float32))
    seg = torch.from_numpy(rng.integers(0, M + 2, (B, S)).astype(np.int32))
    mask = torch.from_numpy(rng.random((B, S)) < 0.7)
    upstream = torch.from_numpy(rng.normal(size=(B, M)).astype(np.float32))
    grads = []
    for fn in (segment_sum_autograd, segment_sum_ref):
        nll = nll0.clone().requires_grad_(True)
        sums, counts = fn(nll, seg, mask, max_segments=M)
        (sums * upstream).sum().backward()
        grads.append(nll.grad)
    np.testing.assert_array_equal(grads[0].numpy(), grads[1].numpy())
    dead = ~(mask & (seg >= 1) & (seg <= M))
    assert (grads[0][dead] == 0).all() and (grads[0][~dead] != 0).all()


def test_per_segment_xent_matches_jax():
    rng = np.random.default_rng(2)
    B, S, d, V, M = 4, 32, 32, 128, 4
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.1).astype(np.float32)
    seg = rng.integers(0, M + 1, (B, S)).astype(np.int32)
    labels = np.where(seg == 0, -1, rng.integers(0, V, (B, S))).astype(
        np.int32)
    got, got_c = per_segment_xent(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(seg), max_segments=M)
    want, want_c = jax_per_segment_xent(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
        jnp.asarray(seg), max_segments=M, ctx=ShardCtx(), seq_chunk=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

def _packed_and_exploded(S=32, M=3):
    """One packed row with M documents, and M rows that keep one document
    each at the same offsets (the reference test's construction)."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 64, L).astype(np.int32) for L in (10, 8, 9)][:M]
    src = PackedSource(docs, S, max_segments=M)
    assert len(src) == 1
    packed = src.batch(np.arange(1))
    seg = packed["segment_ids"]
    exploded = {
        "tokens": np.repeat(packed["tokens"], M, axis=0),
        "positions": np.repeat(packed["positions"], M, axis=0),
        "labels": np.stack([np.where(seg[0] == m + 1, packed["labels"][0],
                                     -1) for m in range(M)]),
        "segment_ids": np.stack([np.where(seg[0] == m + 1, seg[0], 0)
                                 for m in range(M)]),
        "doc_ids": np.stack([np.where(np.arange(M) == m,
                                      packed["doc_ids"][0], -1)
                             for m in range(M)]),
    }
    return packed, exploded


def test_packed_vs_exploded_rows():
    jcfg = get_smoke_config("qwen1.5-0.5b")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = tengine.init_train_state(
        cfg, tengine.ESConfig(n_train=8), TOptConfig(), 0, "cpu").params
    packed, exploded = _packed_and_exploded()
    with torch.no_grad():
        ps_packed, c_packed = lm_per_segment_loss(cfg, params,
                                                  _torch_batch(packed))
        ps_expl, c_expl = lm_per_segment_loss(cfg, params,
                                              _torch_batch(exploded))
    for m in range(3):
        assert c_packed[0, m] == c_expl[m, m] > 0
        np.testing.assert_allclose(float(ps_packed[0, m]),
                                   float(ps_expl[m, m]), rtol=0, atol=1e-6)


def test_packed_step_matches_jax():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    B, M, S, b, n_docs = 4, 4, 32, 6, 40
    src = JaxPackedSource.synthetic(n_docs, S, max_segments=M, seed=2)
    host = src.batch(np.arange(B))
    n_valid = int((host["doc_ids"] >= 0).sum())
    assert b < n_valid < B * M                # selection over a partial row
    es_cfg = ESConfig(method="es", minibatch=b, n_train=n_docs, seq_chunk=0)
    opt_cfg = OptConfig(lr=1e-3)
    eng = ESEngine(cfg, es_cfg, opt_cfg, get_schedule("cosine", 16, 0),
                   ShardCtx())
    state = init_train_state(cfg, es_cfg, opt_cfg, jax.random.PRNGKey(0), B)
    rng = np.random.default_rng(5)
    s0 = rng.uniform(0.5, 6.0, n_docs).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, n_docs).astype(np.float32)
    seen0 = rng.integers(0, 3, n_docs).astype(np.int32)
    state = dataclasses.replace(state, scores=ESScores(
        s=jnp.asarray(s0), w=jnp.asarray(w0), seen=jnp.asarray(seen0)))
    params0 = jax.device_get(state.params)
    gumbel = np.asarray(jax.random.gumbel(jax.random.split(state.rng)[1],
                                          (B * M,), jnp.float32))
    new, jm = jax.jit(eng.packed_step)(state, {k: jnp.asarray(v)
                                               for k, v in host.items()})

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    t_es = tengine.ESConfig(method="es", minibatch=b, n_train=n_docs)
    t_opt = TOptConfig(lr=1e-3)
    teng = tengine.ESEngine(tcfg, t_es, t_opt,
                            t_get_schedule("cosine", 16, 0))
    tstate = tengine.init_train_state(tcfg, t_es, t_opt, 0, "cpu",
                                      params=params_from_jax(params0))
    tstate.scores.s.copy_(torch.from_numpy(s0))
    tstate.scores.w.copy_(torch.from_numpy(w0))
    tstate.scores.seen.copy_(torch.from_numpy(seen0))
    tstate, m = teng.packed_step(tstate, _torch_batch(host),
                                 gumbel=torch.from_numpy(gumbel.copy()))

    # the kept slots: b valid documents, the same set as JAX's update
    assert float(m["bp_samples"]) == float(jm["bp_samples"]) == b
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["sel_loss"]), float(jm["sel_loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(new.scores.seen))
    assert tstate.opt.step == int(new.opt.step) == 1
    got, want = _flat(params_to_numpy(tstate.params)), _flat(new.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    for name in ("s", "w"):
        np.testing.assert_allclose(getattr(tstate.scores, name).numpy(),
                                   np.asarray(getattr(new.scores, name)),
                                   atol=1e-5, rtol=1e-4)
    for name in ("drift_s", "drift_w"):
        np.testing.assert_allclose(float(getattr(tstate.cadence, name)),
                                   float(getattr(new.cadence, name)),
                                   atol=1e-5, rtol=1e-4)
    # JAX's kept mask, rebuilt from the pieces its step uses
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    per_seg, _ = lm_per_segment_loss_jax(cfg, state.params, jb, ShardCtx(),
                                         seq_chunk=0)
    flat = jb["doc_ids"].reshape(-1)
    valid = flat >= 0
    wj = jnp.where(valid, jax_weights(state.scores.s[jnp.maximum(flat, 0)],
                                      per_seg.reshape(-1), 0.2), 0.0)
    want_kept = masked_select_kept_jax("es", jax.random.split(state.rng)[1],
                                       wj, valid, b)
    np.testing.assert_array_equal(m["kept"].numpy(), np.asarray(want_kept))


def test_packed_step_m1_matches_es_step():
    """One document per row reduces packing to serial ES: the same
    documents scored, selected and learned (SGD with momentum, as the
    reference's test: Adam would blow ulp-level gradient noise up)."""
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        get_smoke_config("qwen1.5-0.5b"), compute_dtype="float32")))
    rng = np.random.default_rng(7)
    S = 32
    docs = [rng.integers(1, 64, int(L)).astype(np.int32)
            for L in rng.integers(8, S + 1, 16)]
    src = PackedSource(docs, S, max_segments=1)
    assert len(src) == src.n_docs == 16
    es_cfg = tengine.ESConfig(method="es", minibatch=2, n_train=16)
    opt_cfg = TOptConfig(kind="sgdm", lr=1e-2)
    eng = tengine.ESEngine(cfg, es_cfg, opt_cfg, lambda s: 1.0)
    params = tengine.init_train_state(cfg, es_cfg, opt_cfg, 0, "cpu").params
    s_packed, s_es = (tengine.init_train_state(
        cfg, es_cfg, opt_cfg, 0, "cpu",
        params=_clone(params)) for _ in range(2))
    for step in range(3):
        rows = np.arange(step * 8, (step + 1) * 8) % 16
        pb = _torch_batch(src.batch(rows))
        eb = {"tokens": pb["tokens"], "labels": pb["labels"],
              "sample_ids": pb["doc_ids"].reshape(-1)}
        s_packed, mp = eng.packed_step(s_packed, pb)
        s_es, me = eng.es_step(s_es, eb)
        assert float(mp["bp_samples"]) == float(me["bp_samples"]) == 2.0
        np.testing.assert_allclose(float(mp["loss"]), float(me["loss"]),
                                   rtol=1e-4)
    np.testing.assert_array_equal(s_packed.scores.seen.numpy(),
                                  s_es.scores.seen.numpy())
    np.testing.assert_allclose(s_packed.scores.s.numpy(),
                               s_es.scores.s.numpy(), rtol=1e-4, atol=1e-5)
    a, b = _flat(params_to_numpy(s_packed.params)), \
        _flat(params_to_numpy(s_es.params))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()
