"""PyTorch port: set-level pruning (ESWP, InfoBatch, UCB, KA, random)
against the JAX package.

* ``prune_epoch_snapshot`` for every method and ``none``, on the inputs,
  ratios and ``prev_losses`` of ``tests/test_pruning.py``: kept-set and
  ``grad_scale`` bitwise equal to the reference's from the same numpy
  generator;
* both stores' ``prune_snapshot``/``prune_epoch`` on states carried across
  with the bridge (the int8 ring non-empty): snapshot arrays, kept-sets,
  ``grad_scale`` and the ``prev_epoch_losses`` snapshot bitwise;
* ``ESEngine.prune_decision`` over a table of (cadence, drift since the
  last prune, epochs since the last prune), as ``tests/test_engine.py``
  gates the reference's, and ``reset_prune_drift``;
* the sampler after ``apply_pruning`` against the reference ``ESSampler``:
  permutation, steps, ``grad_scale_for``, the batches' ``grad_scale``,
  digest, cursor and extras, and a resume whose digest differs raises;
* the pruned horizon of the trainer (``tests/test_pipeline.py:293-305``);
* the trainers end to end, port and JAX from the same converted
  parameters (qwen1.5 smoke at float32), for ``eswp`` on the drift prune
  cadence, ``infobatch`` and packed ``eswp``: ``prune_events`` (the drift
  read within 1e-3), ``epoch_log`` and every epoch's kept-set equal, the
  losses within 1e-3 relative (``test_torch_train.py``'s tolerance). The
  reference's batch-level Gumbel noise comes from ``jax.random`` and the
  port's from torch, so these runs take every row of a meta-batch
  (``minibatch`` = meta-batch; packed: every slot): the steps are then
  deterministic and the set-level decision is what is compared;
* a checkpoint mid-epoch 1, after a prune, resumed on the CPU against the
  uninterrupted run (ESWP serial, pipelined with a held batch, InfoBatch's
  grad scales, and a checkpoint at the epoch's end that re-prunes on
  resume): tail losses, every state leaf, the kept-set and its digest and
  ``prev_epoch_losses`` bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.core import engine as jengine
from repro.core import pruning as jpruning
from repro.core import scores as jscores
from repro.data.pipeline.sampler import ESSampler as JaxSampler
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro.models.layers import ShardCtx
from repro.optim.adamw import OptConfig
from repro_torch.bridge import params_from_jax, scores_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.core import engine as tengine
from repro_torch.core import pruning as tpruning
from repro_torch.core import scores as tscores
from repro_torch.data.sampler import ESSampler, kept_digest
from repro_torch.launch import train as ttrain
from repro_torch.optim.adamw import OptConfig as TOptConfig

METHODS = ("eswp", "infobatch", "ucb", "ka", "random", "none")


def _stats(n=512, seed=0):
    """``tests/test_pruning.py``'s inputs."""
    rng = np.random.default_rng(seed)
    w = np.abs(rng.normal(1.0, 0.5, n)).astype(np.float32)
    losses = np.abs(rng.normal(1.0, 0.5, n)).astype(np.float32)
    seen = rng.integers(1, 10, n).astype(np.int32)
    return w, losses, seen


def _same_result(got, want):
    np.testing.assert_array_equal(got.kept, want.kept)
    assert got.kept.dtype == want.kept.dtype
    if want.grad_scale is None:
        assert got.grad_scale is None
    else:
        assert got.grad_scale.dtype == want.grad_scale.dtype
        np.testing.assert_array_equal(got.grad_scale, want.grad_scale)


# ---------------------------------------------------------------------------
# the decision on one snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.9])
def test_prune_epoch_matches_jax(method, ratio):
    w, losses, seen = _stats()
    kw = dict(weights=w, losses=losses, seen=seen, prev_losses=losses * 1.1,
              ratio=ratio)
    got = tpruning.prune_epoch(method, np.random.default_rng(1), **kw)
    want = jpruning.prune_epoch(method, np.random.default_rng(1), **kw)
    _same_result(got, want)


@pytest.mark.parametrize("ka_tau,decayed", [(1.0, None), (0.7, None),
                                            (0.7, 0.5)])
def test_ka_move_back_matches_jax(ka_tau, decayed):
    """The KA cases of ``tests/test_pruning.py``: the plain rule, a decay
    tolerance, and samples that decayed enough to stay hidden."""
    n = 100
    losses = np.linspace(0.1, 2.0, n).astype(np.float32)
    prev = losses / 0.9
    if decayed is not None:
        prev[:5] = losses[:5] / decayed
    kw = dict(weights=losses, losses=losses, prev_losses=prev, ratio=0.3,
              ka_tau=ka_tau)
    _same_result(tpruning.prune_epoch("ka", np.random.default_rng(0), **kw),
                 jpruning.prune_epoch("ka", np.random.default_rng(0), **kw))


def test_blocked_snapshot_gives_one_block_result():
    """The global-position draws: a snapshot in three blocks gives the
    one-block kept-set (the reference's layout invariance)."""
    w, losses, seen = _stats(300)
    cuts = [0, 70, 190, 300]
    snap = tpruning.PruneSnapshot(
        weights=[w[a:b] for a, b in zip(cuts, cuts[1:])],
        losses=[losses[a:b] for a, b in zip(cuts, cuts[1:])],
        seen=[seen[a:b] for a, b in zip(cuts, cuts[1:])],
        offsets=np.asarray(cuts[:-1], np.int64), n=300)
    for method in METHODS:
        got = tpruning.prune_epoch_snapshot(
            method, np.random.default_rng(3), snap,
            prev_losses=losses * 1.1, ratio=0.3)
        want = jpruning.prune_epoch(method, np.random.default_rng(3),
                                    weights=w, losses=losses, seen=seen,
                                    prev_losses=losses * 1.1, ratio=0.3)
        _same_result(got, want)
    np.testing.assert_array_equal(snap.full_losses(), losses)


# ---------------------------------------------------------------------------
# the stores' snapshots
# ---------------------------------------------------------------------------

def _jax_f32_store(n=256, steps=3, B=48, seed=0):
    st = jscores.make_store(None)
    sc = st.init_leaf(n)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ids = jnp.asarray(rng.choice(n, B, replace=False), jnp.int32)
        sc = st.update(sc, ids, jnp.asarray(rng.uniform(0.1, 2.0, B),
                                            jnp.float32), 0.2, 0.9)
    return st, jax.device_get(sc)


def _jax_quant_store(n=256, block=64, R=32, steps=3, B=48, seed=0):
    """Three unique-id batches of 48 through a ring of 32: the ring is
    full and its rows are the newest batch's."""
    st = jscores.make_store(None, quantize=True, block=block,
                            residual_rows=R)
    qs = st.init_leaf(n)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ids = jnp.asarray(rng.choice(n, B, replace=False), jnp.int32)
        qs = st.update(qs, ids, jnp.asarray(rng.uniform(0.1, 2.0, B),
                                            jnp.float32), 0.2, 0.9)
    return st, jax.device_get(qs)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_store_snapshot_and_prune_match_jax(kind):
    if kind == "f32":
        jst, jsc = _jax_f32_store()
        tst = tscores.make_store(None)
    else:
        jst, jsc = _jax_quant_store()
        assert (np.asarray(jsc.err_seq) > 0).all()
        tst = tscores.make_store(None, quantize=True, block=64,
                                 residual_rows=32)
    tsc = scores_from_jax(jsc)
    got, want = tst.prune_snapshot(tsc), jst.prune_snapshot(jsc)
    assert type(got).__name__ == type(want).__name__
    assert got.n == want.n
    np.testing.assert_array_equal(got.offsets, want.offsets)
    for f in ("weights", "losses", "seen") + (
            ("q_losses", "q_scales") if kind == "int8" else ()):
        for g, x in zip(getattr(got, f), getattr(want, f)):
            assert g.dtype == x.dtype, f
            np.testing.assert_array_equal(g, x, err_msg=f)
    prev = np.asarray(want.losses[0]) * 1.1
    for method in METHODS:
        g_res, g_s = tst.prune_epoch(method, np.random.default_rng(7), tsc,
                                     prev_losses=prev, ratio=0.25)
        w_res, w_s = jst.prune_epoch(method, np.random.default_rng(7), jsc,
                                     prev_losses=prev, ratio=0.25)
        _same_result(g_res, w_res)
        np.testing.assert_array_equal(g_s, w_s)
    # the snapshot is a copy: the store's later updates do not reach it
    s0 = got.losses[0].copy()
    tst.update(tsc, torch.arange(8), torch.full((8,), 9.0), 0.2, 0.9)
    np.testing.assert_array_equal(got.losses[0], s0)


# ---------------------------------------------------------------------------
# the engine's prune cadence
# ---------------------------------------------------------------------------

PRUNE_TABLE = [
    # (prune_kind, since_prune drift, epochs_since_prune)
    ("epoch", 0.0, 0), ("epoch", 0.5, 1), ("drift", 0.0, 0),
    ("drift", 0.0, 3), ("drift", 0.24, 1), ("drift", 0.25, 1),
    ("drift", 0.5, 0), ("drift", 0.0, 4), ("drift", 0.5, 5)]


def test_prune_decision_matches_jax():
    cfg = get_smoke_config("qwen1.5-0.5b")
    for kind in ("epoch", "drift"):
        kw = dict(kind="drift", prune_kind=kind, prune_drift_floor=0.25,
                  prune_max_interval=4)
        jeng = jengine.ESEngine(cfg, jengine.ESConfig(), OptConfig(),
                                lambda s: 1.0, ShardCtx(),
                                cadence=jengine.CadenceConfig(**kw))
        teng = tengine.ESEngine(ModelConfig(**dataclasses.asdict(cfg)),
                                tengine.ESConfig(), TOptConfig(),
                                lambda s: 1.0,
                                cadence=tengine.CadenceConfig(**kw))
        for pk, drift, since in PRUNE_TABLE:
            if pk != kind:
                continue
            jcad = dataclasses.replace(
                jengine.init_cadence(),
                since_prune=jnp.asarray(drift, jnp.float32))
            tcad = dataclasses.replace(
                tengine.init_cadence("cpu"),
                since_prune=torch.tensor(drift, dtype=torch.float32))
            want = jeng.prune_decision(jcad, since)
            assert teng.prune_decision(tcad, since) == want, (pk, drift,
                                                              since)
            assert teng.should_prune(tcad, since) == want[0]
            assert teng.prune_decision(None, since) == \
                jeng.prune_decision(None, since)


def test_reset_prune_drift_zeroes_the_accumulator():
    cfg = ModelConfig(**dataclasses.asdict(get_smoke_config("qwen1.5-0.5b")))
    eng = tengine.ESEngine(cfg, tengine.ESConfig(n_train=8), TOptConfig(),
                           lambda s: 1.0)
    state = tengine.init_train_state(cfg, eng.es_cfg, eng.opt_cfg, 0, "cpu")
    state.cadence.since_prune.fill_(0.5)
    state = eng.reset_prune_drift(state)
    assert float(state.cadence.since_prune) == 0.0
    assert state.cadence.since_prune.dtype == torch.float32


# ---------------------------------------------------------------------------
# the sampler's kept-set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
def test_sampler_kept_set_matches_jax(drop_last):
    n, mb = 100, 8
    res = jpruning.prune_epoch("infobatch", np.random.default_rng(0),
                               weights=_stats(n)[0], losses=_stats(n)[1],
                               ratio=0.5)
    got = ESSampler(n, mb, seed=3, drop_last=drop_last)
    want = JaxSampler(n, mb, seed=3, drop_last=drop_last)
    assert got.cursor(0, 0) == want.cursor(0, 0)
    for s in (got, want):
        s.apply_pruning(res.kept, res.grad_scale)
    assert len(res.kept) < n
    for epoch in (0, 1):
        np.testing.assert_array_equal(got.epoch_indices(epoch),
                                      want.epoch_indices(epoch))
        assert got.steps_per_epoch(epoch) == want.steps_per_epoch(epoch)
        np.testing.assert_array_equal(got.batch_ids(epoch, 2),
                                      want.batch_ids(epoch, 2))
    ids = np.asarray([0, 5, 99, 100, 150])
    np.testing.assert_array_equal(got.grad_scale_for(ids),
                                  want.grad_scale_for(ids))
    src = _IdSource()
    for gb, wb in zip(got.epoch_batches(src, 1, 1),
                      want.epoch_batches(src, 1, 1)):
        np.testing.assert_array_equal(gb["sample_ids"], wb["sample_ids"])
        np.testing.assert_array_equal(gb["grad_scale"], wb["grad_scale"])
    assert got.cursor(1, 3) == want.cursor(1, 3)
    assert got.cursor(1, 3)["kept_digest"] == kept_digest(res.kept) != "full"
    ga, wa = got.state_arrays(), want.state_arrays()
    assert set(ga) == set(wa) == {"sampler_kept", "sampler_grad_scale"}
    for k in ga:
        assert ga[k].dtype == wa[k].dtype
        np.testing.assert_array_equal(ga[k], wa[k])
    # a resume reinstalls both, and a digest of another kept-set raises
    fresh = ESSampler(n, mb, seed=3, drop_last=drop_last)
    fresh.load_state(ga, got.cursor(1, 3))
    np.testing.assert_array_equal(fresh.epoch_indices(1),
                                  got.epoch_indices(1))
    np.testing.assert_array_equal(fresh.grad_scale, res.grad_scale)
    with pytest.raises(ValueError, match="digest"):
        ESSampler(n, mb, seed=3, drop_last=drop_last).load_state(
            {}, got.cursor(1, 3))
    # pruning lifted: every id again, digest "full"
    got.apply_pruning(None)
    assert got.steps_per_epoch(0) == ESSampler(
        n, mb, drop_last=drop_last).steps_per_epoch(0)
    assert got.cursor(0, 0)["kept_digest"] == "full"
    assert got.state_arrays() == {}


class _IdSource:
    def batch(self, ids):
        return {"sample_ids": np.asarray(ids, np.int32)}


def test_pruned_horizon_matches_jax():
    """An epoch over the kept-set: the warmup schedule and the learning-
    rate total sized from the pruned count, the actual count re-read from
    the sampler each epoch (the reference's
    ``test_steps_per_epoch_sees_pruned_horizon``)."""
    base = dict(arch="qwen1.5-0.5b", method="eswp", epochs=3,
                meta_batch=16, minibatch=4, n_samples=128, seq_len=32,
                lr=3e-3, anneal_ratio=0.0, pruning_ratio=0.5,
                freq_schedule="warmup", score_every=4)
    tr = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **base))
    jt = JaxTrainer(JaxTrainerConfig(**base))
    # 128 samples, ratio 0.5 -> 64 kept -> 4 steps an epoch (not 8)
    assert tr.planned_steps_per_epoch(0) == jt.planned_steps_per_epoch(0) \
        == 4
    assert tr.freq.warmup_steps == jt.freq.warmup_steps == 2
    assert tr.freq.ramp_steps == jt.freq.ramp_steps == 4
    assert tr._epoch_counts() == jt._epoch_counts()
    out = tr.train()
    assert [e["steps_per_epoch"] for e in out["epoch_log"]] == [4, 4, 4]
    assert out["steps"] == 12
    assert all(r["epochs_since_prune"] == 0 for r in out["metrics"])
    # a batch-level method keeps the full horizon; packed rows never shrink
    for kw in (dict(method="es"), dict(pack=True, max_segments=4)):
        t2 = ttrain.Trainer(ttrain.TrainerConfig(
            device="cpu", **{**base, **kw}))
        j2 = JaxTrainer(JaxTrainerConfig(**{**base, **kw}))
        assert t2.planned_steps_per_epoch(0) == j2.planned_steps_per_epoch(0)
        assert t2.planned_steps_per_epoch(pruned=True) == \
            j2.planned_steps_per_epoch(pruned=True)


# ---------------------------------------------------------------------------
# the trainers end to end
# ---------------------------------------------------------------------------

E2E = {
    # drift prune cadence: the first prune, then the drift gate decides
    "eswp-drift": dict(method="eswp", prune_cadence="drift", meta_batch=16,
                       minibatch=16, n_samples=64),
    "infobatch": dict(method="infobatch", meta_batch=16, n_samples=64),
    # documents pruned inside rows: 48 documents in ~15 rows of 32
    "packed-eswp": dict(method="eswp", pack=True, max_segments=4,
                        meta_batch=4, minibatch=16, n_samples=48),
}


def _kept_log(trainer, per_epoch):
    """Wrap ``_prune_for_epoch`` to record each epoch's kept-set."""
    inner = trainer._prune_for_epoch
    pipe = getattr(trainer, "pipeline", None) or trainer.loader

    def hook(epoch):
        inner(epoch)
        if pipe.doc_level:
            per_epoch.append(np.flatnonzero(
                pipe.source.doc_state_arrays()["doc_kept"]))
        else:
            per_epoch.append(pipe.sampler.kept)
            per_epoch.append(pipe.sampler.grad_scale)
    trainer._prune_for_epoch = hook


@pytest.mark.parametrize("case", list(E2E))
def test_trainer_matches_jax_trainer(case):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    common = dict(arch="qwen1.5-0.5b", smoke=True, seq_len=32, epochs=3,
                  **E2E[case])
    jt = JaxTrainer(JaxTrainerConfig(**common), model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    jkept, tkept = [], []
    _kept_log(jt, jkept)
    jout = jt.train()
    tt = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **common),
                        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
                        init_params=params_from_jax(params0))
    _kept_log(tt, tkept)
    out = tt.train()
    assert out["epoch_log"] == jout["epoch_log"]
    assert len(out["prune_events"]) == len(jout["prune_events"]) == 3
    for g, w in zip(out["prune_events"], jout["prune_events"]):
        drift_g = g.pop("since_prune_drift")
        drift_w = w.pop("since_prune_drift")
        assert g == w
        assert drift_g == pytest.approx(drift_w, rel=1e-3)
    assert out["prune_events"][0]["reason"] == "first-prune"
    assert len(tkept) == len(jkept)
    for g, w in zip(tkept, jkept):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    if case == "eswp-drift":       # round(0.8 * 64) kept, 3 steps an epoch
        assert all(len(k) == 51 for k in tkept[::2])
    if case == "infobatch":        # epoch 1 trains with scales of 1.25
        assert (tkept[3] == 1.25).any() and len(tkept[2]) < 64
    np.testing.assert_array_equal(tt.prev_epoch_losses.shape,
                                  jt.prev_epoch_losses.shape)
    got = [r["loss"] for r in out["metrics"]]
    want = [r["loss"] for r in jout["metrics"]]
    assert len(got) == len(want) == out["steps"] == jout["steps"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert [r["epochs_since_prune"] for r in out["metrics"]] == \
        [r["epochs_since_prune"] for r in jout["metrics"]]
    assert out["bp_samples_total"] == jout["bp_samples_total"]


def test_pruned_documents_reach_the_store_as_minus_one():
    """Packed ESWP prunes documents inside rows: after the first prune
    (epoch 0) every row still streams, a pruned document's slot carries
    -1 and its labels are masked, so the store never sees it, while each
    kept document is scored once."""
    tr = ttrain.Trainer(ttrain.TrainerConfig(
        arch="qwen1.5-0.5b", device="cpu", method="eswp", pack=True,
        max_segments=4, meta_batch=4, minibatch=16, seq_len=32,
        n_samples=48, epochs=1))
    out = tr.train()
    kept = tr.source.doc_state_arrays()["doc_kept"].astype(bool)
    assert kept.sum() == round(0.8 * 48) and tr.pipeline.has_pruning
    assert out["epoch_log"][0]["steps_per_epoch"] == len(tr.source) // 4
    seen = tr.state.scores.seen.numpy()
    assert (seen[~kept] == 0).all() and (seen[kept] == 1).all()
    batch = tr.pipeline.batch_at(0, 0)
    slots = tr.source._doc_ids[batch["sample_ids"]]
    pruned = (slots >= 0) & ~kept[np.clip(slots, 0, None)]
    assert (batch["doc_ids"][pruned] == -1).all()
    assert (batch["doc_ids"][~pruned] == slots[~pruned]).all()


@pytest.mark.parametrize("method", ["ucb", "ka", "random"])
def test_other_set_level_cli_runs_on_cpu(method, capsys):
    """The other set-level methods through the CLI: baseline steps over
    ``round(0.8 n)`` kept samples (KA moves hidden samples back, so it
    keeps at least that many), a prune event each epoch."""
    out = ttrain.main(["--arch", "qwen1.5-0.5b", "--method", method,
                       "--meta-batch", "8", "--seq-len", "16",
                       "--n-samples", "40", "--epochs", "2",
                       "--prune-cadence", "drift", "--device", "cpu"])
    assert np.all(np.isfinite([r["loss"] for r in out["metrics"]]))
    assert [e["fired"] for e in out["prune_events"]] == [True, True]
    spe = [e["steps_per_epoch"] for e in out["epoch_log"]]
    assert spe[0] == 4 and all(s >= 4 for s in spe)
    assert out["bp_samples_total"] == 8.0 * out["steps"]
    assert "prune_events" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# resume across a prune
# ---------------------------------------------------------------------------

RBASE = dict(arch="qwen1.5-0.5b", device="cpu", method="eswp", meta_batch=8,
             minibatch=2, seq_len=16, n_samples=40, epochs=3)

RESUMES = {
    # 32 kept -> 4 steps an epoch; step 6 is mid-epoch 1
    "serial": (dict(), 6),
    "pipelined_held": (dict(pipelined=True), 6),
    "infobatch": (dict(method="infobatch"), 6),
    # the checkpoint closes epoch 0: the resumed run prunes epoch 1
    "epoch_end": (dict(prune_cadence="drift"), 4),
}


def _state_equal(a, b):
    from repro_torch.checkpoint.checkpointer import flatten
    fa, fb = flatten(a), flatten(b)
    assert set(fa) == set(fb)
    for k in fb:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("case", list(RESUMES))
def test_resume_across_prune_bit_exact(case, tmp_path):
    kw, stop_at = RESUMES[case]
    tc = {**RBASE, **kw}
    ref = ttrain.Trainer(ttrain.TrainerConfig(max_steps=12, **tc))
    ref_out = ref.train()
    ttrain.Trainer(ttrain.TrainerConfig(max_steps=stop_at,
                                        ckpt_dir=str(tmp_path), **tc)).train()
    res = ttrain.Trainer(ttrain.TrainerConfig(max_steps=12,
                                              ckpt_dir=str(tmp_path), **tc))
    assert res.global_step == stop_at and res._pruned_in_process
    assert res._resume_held == (case == "pipelined_held")
    out = res.train()
    assert [m["loss"] for m in out["metrics"]] == \
        [m["loss"] for m in ref_out["metrics"][stop_at:]]
    assert [m["epochs_since_prune"] for m in out["metrics"]] == \
        [m["epochs_since_prune"] for m in ref_out["metrics"][stop_at:]]
    _state_equal(res.engine.state_dict(res.state),
                 ref.engine.state_dict(ref.state))
    for a, b in ((res.sampler.kept, ref.sampler.kept),
                 (res.sampler.grad_scale, ref.sampler.grad_scale),
                 (res.prev_epoch_losses, ref.prev_epoch_losses)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert res.pipeline.cursor(2, 0) == ref.pipeline.cursor(2, 0)
    assert ref.pipeline.cursor(2, 0)["kept_digest"] != "full"
    # the resumed run re-prunes only at an epoch's start
    assert [e["epoch"] for e in out["prune_events"]] == (
        [1, 2] if case == "epoch_end" else [2])
