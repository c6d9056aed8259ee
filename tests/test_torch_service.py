"""PyTorch port: admission and the online scoring service against the JAX
package.

* ``es_admission_filter`` and ``AdmissionController`` (a fake clock; the
  batch and latency bounds, the row-count check, the latency stats) give
  JAX's results on the same submissions;
* the service grows a smoke trainer mid-run (qwen1.5 smoke, float32, the
  same converted parameters on both sides): every row of a meta-batch is
  trained (b = B), since the two frameworks' batch-level Gumbel noise
  differs. The admission log, ``n_train``, the store's rows, the
  sampler's population, the source's length, the epoch log and the
  losses (1e-3 relative) equal JAX's; the admitted rows were scored once
  from their measured loss; the decode server reads the trainer's
  parameter tensors themselves;
* a run whose step hook appends rows and grows at step 1, checkpointed
  mid-epoch 1 and resumed, equals the uninterrupted run bitwise (tail
  losses, every state leaf, the cursor); a grown run restored into a
  fresh trainer equals an ungrown run on the original rows;
* ``Trainer.grow`` refuses rows the source lacks, the service refuses a
  trainer without a ``StreamingSource``, and the service CLI runs with
  ``--device cpu`` and refuses the default ``cuda`` without a GPU; its
  ``--bench-out`` writes the reference's admission rows.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from _torch_parity import smoke_cfg
from repro.data.pipeline import AdmissionController as JaxController
from repro.data.pipeline import StreamingSource as JaxStreaming
from repro.data.pipeline import SyntheticSource as JaxSynthetic
from repro.data.pipeline import es_admission_filter as jax_filter
from repro.launch.service import ScoringService as JaxService
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.data.pipeline import (AdmissionController, StreamingSource,
                                       SyntheticSource, es_admission_filter)
from repro_torch.launch import service as tservice
from repro_torch.launch import train as ttrain

S = 16
BASE = dict(arch="qwen1.5-0.5b", method="es", epochs=2, meta_batch=8,
            minibatch=8, n_samples=16, seq_len=S, lr=3e-3, anneal_ratio=0.0)


def _rows(n, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((n, 1), -1, np.int32)],
                            axis=1)
    return tokens, labels


def test_admission_filter_matches_jax():
    rng = np.random.default_rng(0)
    losses = rng.uniform(0.0, 3.0, 64).astype(np.float32)
    for s_ref, w_ref, beta1, tau in ((1.0, 1.0, 0.2, 1.0),
                                     (0.3, 2.1, 0.5, 0.7),
                                     (1.7, 0.4, 0.0, 2.0),
                                     (1.0, 1.0, 0.2, 0.0)):
        kw = dict(s_ref=s_ref, w_ref=w_ref, beta1=beta1, tau=tau)
        got, want = es_admission_filter(losses, **kw), jax_filter(losses,
                                                                  **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert es_admission_filter(losses, s_ref=1.0, w_ref=1.0, beta1=0.2,
                               tau=0.0).all()


def _drive_controller(cls):
    """Submissions, polls and flushes on a fake clock -> every result."""
    clock = [0.0]
    ctl = cls(lambda t, l: t[:, 0].astype(np.float32),
              lambda losses: losses >= 20.0, max_batch=4, max_delay_s=0.5,
              clock=lambda: clock[0])
    tok, lab = _rows(11, seed=1)
    out = []
    ctl.submit(tok[:3], lab[:3])
    for t in (0.1, 0.4, 0.51):
        clock[0] = t
        out.append(ctl.poll())
    ctl.submit(tok[3:9], lab[3:9])
    clock[0] = 0.6
    out += [ctl.poll(), ctl.poll()]
    ctl.submit(tok[9], lab[9])
    clock[0] = 2.0
    out += [ctl.poll(), ctl.flush(), ctl.flush()]
    out.append((len(ctl), ctl.submitted, ctl.admitted, ctl.latency_stats()))
    with pytest.raises(ValueError, match="shape"):
        ctl.submit(tok[:2], lab[:1, :4])
    bad = cls(lambda t, l: np.zeros(1, np.float32), lambda x: x > 0,
              max_batch=2, max_delay_s=0.0)
    bad.submit(tok[:2], lab[:2])
    with pytest.raises(ValueError, match="score_fn"):
        bad.poll()
    with pytest.raises(ValueError, match="max_batch"):
        cls(None, None, max_batch=0)
    return out


def test_admission_controller_matches_jax():
    got, want = (_drive_controller(AdmissionController),
                 _drive_controller(JaxController))
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert (g is None) == (w is None)
        if w is None:
            continue
        for f in ("tokens", "labels", "losses", "admitted", "latencies_s"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
    assert got[-1] == want[-1]
    assert got[2] is not None and got[2].admitted.tolist() != []


def _trainers():
    """(JAX trainer, port trainer) over StreamingSources, the same
    converted parameters, float32."""
    cfg = smoke_cfg()
    tc = BASE
    kw = dict(n_samples=16, seq_len=S, vocab_size=64, seed=0)
    jt = JaxTrainer(JaxTrainerConfig(**tc), model_cfg=cfg,
                    source=JaxStreaming(JaxSynthetic(**kw)))
    tt = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **tc),
                        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
                        init_params=params_from_jax(
                            jax.device_get(jt.state.params)),
                        source=StreamingSource(SyntheticSource(**kw)))
    return jt, tt


def _feed_once(svc, trainer, tok, lab, at_step=1):
    def feeder(tr, epoch):
        if tr.global_step == at_step:
            svc.submit(tok, lab)
    trainer.step_hooks.insert(0, feeder)    # before the service's poll


def test_service_grows_mid_run_as_jax():
    jt, tt = _trainers()
    jsvc = JaxService(jt, tau=2.0, max_batch=8, max_delay_s=0.0,
                      serve=False)
    tsvc = tservice.ScoringService(tt, tau=2.0, max_batch=8,
                                   max_delay_s=0.0)
    tok, lab = _rows(8, seed=3)
    tok[::2, ::2] = 7          # half the rows easier to predict
    _feed_once(jsvc, jt, tok, lab)
    _feed_once(tsvc, tt, tok, lab)
    jout, out = jt.train(), tt.train()
    assert jsvc.flush() == tsvc.flush() == 0
    assert len(tsvc.admit_log) == len(jsvc.admit_log) == 1
    for g, w in zip(tsvc.admit_log, jsvc.admit_log):
        assert g.pop("mean_loss") == pytest.approx(w.pop("mean_loss"),
                                                   rel=1e-4)
        assert g == w
    n_adm = jsvc.admission.admitted
    assert 0 < tsvc.admission.admitted == n_adm < 8
    n = 16 + n_adm
    assert tt.n_train == jt.n_train == tt.es_cfg.n_train == n
    assert tt.state.scores.s.shape[0] == jt.state.scores.s.shape[0] == n
    assert tt.sampler.n_samples == jt.pipeline.sampler.n_samples == n
    assert len(tt.source) == len(jt.source) == n
    assert out["epoch_log"] == jout["epoch_log"]
    assert out["epoch_log"][1]["steps_per_epoch"] == n // 8
    got = [r["loss"] for r in out["metrics"]]
    want = [r["loss"] for r in jout["metrics"]]
    assert len(got) == len(want) == 2 + n // 8
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # the admitted rows took their measured loss, then epoch 1's scoring
    seen = tt.state.scores.seen.numpy()
    np.testing.assert_array_equal(seen, np.asarray(jt.state.scores.seen))
    assert (seen[16:] >= 1).all()
    np.testing.assert_allclose(tt.state.scores.s.numpy(),
                               np.asarray(jt.state.scores.s), rtol=1e-3)
    # the decode server reads the live parameter tensors
    assert tsvc.server.params is tt.state.params
    out = tsvc.decode(tok[:2, :4], 3)
    assert out.shape == (2, 7)


def _grow_at_step_1(trainer, tok, lab):
    def hook(tr, epoch):
        if tr.global_step == 1:
            tr.grow(len(tr.source.append(tok, lab)), epoch)
    trainer.step_hooks.append(hook)


def _port_trainer(**over):
    cfg = ModelConfig(**dataclasses.asdict(smoke_cfg()))
    tc = ttrain.TrainerConfig(device="cpu", **dict(BASE, epochs=3, **over))
    return ttrain.Trainer(tc, model_cfg=cfg, source=StreamingSource(
        SyntheticSource(n_samples=16, seq_len=S, vocab_size=64, seed=0)))


@pytest.mark.parametrize("quant", [False, True])
def test_grown_run_resumes_bit_exact(tmp_path, quant):
    """Rows appended and grown at step 1 (epoch 0; epoch 1 walks 24
    rows, 3 steps); killed at step 3, mid-epoch 1, and resumed."""
    tok, lab = _rows(8, seed=5)
    kw = dict(minibatch=4, quant_scores=quant, quant_block=8)
    ref = _port_trainer(**kw)
    _grow_at_step_1(ref, tok, lab)
    ref_out = ref.train()
    assert [e["steps_per_epoch"] for e in ref_out["epoch_log"]] == [2, 3, 3]
    first = _port_trainer(max_steps=3, ckpt_dir=str(tmp_path), **kw)
    _grow_at_step_1(first, tok, lab)
    first.train()
    res = _port_trainer(ckpt_dir=str(tmp_path), **kw)
    assert res.global_step == 3 and res.n_train == 24
    assert res.sampler.population(1) == 24 and len(res.source) == 24
    out = res.train()
    assert [r["loss"] for r in out["metrics"]] == \
        [r["loss"] for r in ref_out["metrics"][3:]]
    want = ref.engine.state_dict(ref.state)
    got = res.engine.state_dict(res.state)
    from repro_torch.checkpoint.checkpointer import flatten
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    assert res.pipeline.cursor(2, 3) == ref.pipeline.cursor(2, 3)


def test_grown_restore_equals_ungrown_on_original_rows(tmp_path):
    n = 16
    ref = _port_trainer()
    ref.train()
    tr = _port_trainer(ckpt_dir=str(tmp_path))
    tr.train()
    tok, lab = _rows(8, seed=6)
    ids = tr.source.append(tok, lab)
    tr.grow(len(ids), epoch=tr.tc.epochs - 1)
    tr._checkpoint(tr.tc.epochs - 1, final=True)
    tr.ckpt.wait()
    tr2 = _port_trainer(ckpt_dir=str(tmp_path))
    assert tr2.n_train == tr2.sampler.n_samples == len(tr2.source) == n + 8
    np.testing.assert_array_equal(tr2.source.batch(ids)["tokens"], tok)
    from repro_torch.models.transformer import tree_leaves
    for a, b in zip(tree_leaves(ref.state.params),
                    tree_leaves(tr2.state.params)):
        assert torch.equal(a, b)
    for f in ("s", "w", "seen"):
        assert torch.equal(getattr(tr2.state.scores, f)[:n],
                           getattr(ref.state.scores, f))
    assert (tr2.state.scores.seen[n:] == 0).all()


def test_grow_and_service_refuse_misuse():
    tr = _port_trainer()
    with pytest.raises(ValueError, match="source"):
        tr.grow(4, epoch=0)
    assert tr.n_train == 16 and tr.state.scores.s.shape[0] == 16
    plain = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **BASE))
    with pytest.raises(ValueError, match="StreamingSource"):
        tservice.ScoringService(plain, serve=False)


def test_service_cli_on_cpu_and_default_device(capsys):
    report = tservice.main(["--device", "cpu", "--epochs", "2",
                            "--n-samples", "16", "--seq-len", "16",
                            "--meta-batch", "8", "--gen", "2"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    assert report["device"] == "cpu"
    assert report["rows_now"] == 16 + report["admitted_total"]
    assert report["submitted"] > 0 and report["decode_shape"] == [2, 10]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tservice.main(["--epochs", "1"])


def test_service_bench_out_writes_reference_rows(tmp_path, capsys):
    out = tmp_path / "bench.json"
    report = tservice.main(["--device", "cpu", "--epochs", "1",
                            "--n-samples", "8", "--seq-len", "8",
                            "--meta-batch", "4", "--submit-every", "1",
                            "--max-batch", "4", "--gen", "1",
                            "--bench-out", str(out)])
    capsys.readouterr()
    rows = json.loads(out.read_text())["rows"]
    stats = JaxController(lambda t, l: None,
                          lambda w: None).latency_stats()
    assert len(rows) == 1
    assert set(rows[0]) == {"method", "k", "steps", "streamed", *stats}
    assert rows[0]["method"] == "admission" and rows[0]["k"] == 4
    assert rows[0]["steps"] == report["steps"]
    assert rows[0]["streamed"] == report["streamed"]
    assert rows[0]["admit_latency_p95_s"] == report["admit_latency_p95_s"]
