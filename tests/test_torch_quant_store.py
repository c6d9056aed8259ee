"""PyTorch port: the int8 score store against the JAX package.

Both sides start from the same store state (carried across with
``bridge.scores_from_jax``) and take the same ids and losses. The contract
is the reference kernel test's (tests/test_kernels.py): integer leaves
(codes, seen, ring ids and stamps) and scales bitwise equal, the float32
ring residuals within atol 1e-7.

* ``_q_ring_slots`` against JAX's (exact);
* the store's update, plain sequential (the CPU path of the kernel
  wrapper) and scatter form (``fused=False``), against JAX's scatter
  ``_q_apply_fixed`` over a stream of unique-id batches;
* masked ids, a warm ring and duplicate ids against JAX's Pallas kernel in
  interpret mode (the scatter form applies duplicates differently);
* a 3-step ``--quant-scores`` trainer run (method ``order``: no selection
  noise) against the JAX trainer: losses rtol 1e-3 (test_torch_train's),
  seen and ring ids exact, gathered scores within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config
from repro.core import scores as jscores
from repro.kernels.score_update.score_update import \
    fused_quant_score_update as jax_quant_kernel
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax, scores_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.core import scores as tscores
from repro_torch.kernels.score_update.ops import fused_quant_score_update
from repro_torch.launch import train as ttrain

B1, B2 = 0.2, 0.9
QFIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
           "err_seq", "err_s", "err_w")


def _assert_q_equal(got, want):
    """Integer leaves and scales bitwise, residuals to atol 1e-7."""
    for f in QFIELDS:
        g = getattr(got, f).numpy()
        x = np.asarray(getattr(want, f))
        assert g.dtype == x.dtype, f
        if f in ("err_s", "err_w"):
            np.testing.assert_allclose(g, x, atol=1e-7, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, x, err_msg=f)


def _warm(n, block, R, steps, B=48, seed=0):
    """A JAX quantized store advanced ``steps`` unique-id batches."""
    st = jscores.make_store(None, quantize=True, block=block,
                            residual_rows=R)
    qs = st.init_leaf(n)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ids = jnp.asarray(rng.choice(n, B, replace=False), jnp.int32)
        qs = st.update(qs, ids, jnp.asarray(rng.uniform(0.1, 2.0, B),
                                            jnp.float32), B1, B2)
    return st, qs, rng


def _port(qs):
    return scores_from_jax(jax.device_get(qs))


def test_make_store_and_init_leaf_match_jax():
    st = tscores.make_store(None, quantize=True, block=64)
    assert isinstance(st, tscores.QuantizedStore)
    assert isinstance(tscores.make_store(None), tscores.ReplicatedStore)
    with pytest.raises(NotImplementedError, match="not ported"):
        tscores.make_store(object(), quantize=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        tscores.make_store(None, quantize=True, wire=True)
    for n, block in ((512, 64), (100, 1024)):
        got = st.init_leaf(n, "cpu") if block == 64 else \
            tscores.make_store(None, quantize=True,
                               block=block).init_leaf(n, "cpu")
        want = jscores.make_store(None, quantize=True,
                                  block=block).init_leaf(n)
        _assert_q_equal(got, want)
    # the f32 leaf converts too
    f32 = scores_from_jax(jax.device_get(jscores.init_scores(8)))
    assert isinstance(f32, tscores.ESScores) and f32.seen.dtype == torch.int32


@pytest.mark.parametrize("B,R,warm", [(16, 64, 0), (16, 64, 40),
                                      (48, 32, 7)])
def test_ring_slots_match_jax(B, R, warm):
    """Empty, partly stamped and full (B > R) rings; a third of the batch
    masked."""
    rng = np.random.default_rng(B + R + warm)
    seq = np.zeros(R, np.int32)
    seq[:min(warm, R)] = rng.permutation(np.arange(1, warm + 1))[:R]
    mask = rng.random(B) > 0.33
    got = tscores._q_ring_slots(torch.from_numpy(seq), torch.from_numpy(mask))
    want = jscores._q_ring_slots(jnp.asarray(seq), jnp.asarray(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fused", [True, False])
def test_update_stream_matches_jax_scatter(fused):
    """Four unique-id batches from a warm store, the ring roomy enough that
    no live residual is recycled inside a batch: the sequential plain
    version and the scatter form both equal JAX's scatter."""
    n, block, R = 512, 64, 512
    st, qs, rng = _warm(n, block, R, steps=2)
    tst = tscores.make_store(None, quantize=True, block=block,
                             residual_rows=R)
    tqs = _port(qs)
    for _ in range(4):
        ids = rng.choice(n, 48, replace=False).astype(np.int32)
        losses = rng.uniform(0.05, 3.0, 48).astype(np.float32)
        qs = st.update(qs, jnp.asarray(ids), jnp.asarray(losses), B1, B2)
        tst.update(tqs, torch.from_numpy(ids), torch.from_numpy(losses), B1,
                   B2, fused=fused)
        _assert_q_equal(tqs, qs)
        got = tst.gather(tqs, torch.from_numpy(ids))
        want = st.gather(qs, jnp.asarray(ids))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)


@pytest.mark.parametrize("case", ["masked", "warm_ring", "duplicates"])
def test_update_matches_jax_kernel(case):
    """The store update (grow prologue, ring slots, plain sequential
    apply) against JAX's store update through its Pallas kernel in
    interpret mode; and the wrapper alone against the kernel alone on the
    same post-prologue inputs."""
    n, block, R, B = 256, 64, 96, 32
    st, qs, rng = _warm(n, block, R, steps=2, B=B)
    if case == "warm_ring":             # the rows the ring holds, again
        ids = np.asarray(qs.err_rows)[np.asarray(qs.err_rows) >= 0][:B]
    else:
        ids = rng.choice(n, B, replace=False)
    ids = np.asarray(ids, np.int32).copy()
    if case == "masked":
        ids[::3] = -1
        ids[1] = n + 5
    if case == "duplicates":
        ids[5] = ids[2]
        ids[9] = ids[2]
        ids[20] = ids[11]
    losses = rng.uniform(0.05, 3.0, B).astype(np.float32)
    want = st.update(qs, jnp.asarray(ids), jnp.asarray(losses), B1, B2,
                     fused=True, interpret=True)
    tst = tscores.make_store(None, quantize=True, block=block,
                             residual_rows=R)
    tqs = _port(qs)
    tst.update(tqs, torch.from_numpy(ids), torch.from_numpy(losses), B1, B2)
    _assert_q_equal(tqs, want)
    if case == "warm_ring":
        assert (np.asarray(want.err_rows) >= 0).sum() > B   # hits, then new

    # the kernel's contract alone, from JAX's own prologue
    mask = (ids >= 0) & (ids < n)
    pos = jnp.asarray(np.where(mask, ids, 0))
    mg = jnp.asarray(np.where(mask, ids, -1))
    grown = jscores._q_grow_scales(qs, pos, jnp.asarray(mask), mg,
                                   jnp.asarray(losses), B1, B2, block)
    slots, seqs = jscores._q_ring_slots(grown.err_seq, jnp.asarray(mask))
    lids = jnp.asarray(np.where(mask, ids, -1))
    args = [getattr(grown, f) for f in QFIELDS] + [lids, mg,
                                                    jnp.asarray(losses),
                                                    slots, seqs]
    kern = jax_quant_kernel(*args, beta1=B1, beta2=B2, block=block,
                            interpret=True)
    targs = [torch.from_numpy(np.array(a, copy=True)) for a in args]
    out = fused_quant_score_update(*targs, beta1=B1, beta2=B2, block=block)
    names = ("s_q", "w_q", "seen_q", "err_rows", "err_seq", "err_s", "err_w")
    for name, g, k in zip(names, out, kern):
        if name in ("err_s", "err_w"):
            np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(k),
                                          err_msg=name)


def test_quant_trainer_matches_jax_trainer():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    common = dict(arch="qwen1.5-0.5b", smoke=True, method="order",
                  meta_batch=16, minibatch=4, seq_len=32, n_samples=64,
                  max_steps=3, quant_scores=True, quant_block=16)
    jt = JaxTrainer(JaxTrainerConfig(**common), model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    want = [r["loss"] for r in jt.train()["metrics"]]
    tt = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **common),
                        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
                        init_params=params_from_jax(params0))
    got = [r["loss"] for r in tt.train()["metrics"]]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    jq, tq = jt.state.scores, tt.state.scores
    assert isinstance(tq, tscores.QuantizedScores)
    for f in ("seen_q", "err_rows"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    assert int(tq.seen_q.to(torch.int32).sum()) == 3 * 16
    ids = np.arange(64, dtype=np.int32)
    got_sw = tt.store.gather(tq, torch.from_numpy(ids))
    want_sw = jt.score_store.gather(jq, jnp.asarray(ids))
    for g, w in zip(got_sw, want_sw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
