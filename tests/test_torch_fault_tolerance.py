"""PyTorch port: preemption and stragglers (``repro_torch.distributed.
fault_tolerance``), held to ``tests/test_fault_tolerance.py``'s three
single-process cases, and the trainer's use of them: a run that sends
itself SIGTERM from a step hook stops at the next step boundary with its
final checkpoint written, and resumed to the same end it is bitwise the
uninterrupted run (``tests/test_torch_checkpoint.py``'s comparison); its
summary's keys are a superset of the JAX trainer's."""
import os
import signal
import time

import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.launch import train as jtrain
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerMonitor)
from repro_torch.launch import train as ttrain


def test_preemption_handler_sets_flag():
    before = signal.getsignal(signal.SIGUSR1)
    h = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not h.preemption_requested
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert h.preemption_requested
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=2.0, warmup_steps=3)
    for i in range(10):
        assert m.record(i, 0.1) is None
    r = m.record(10, 0.5)            # 5x the mean
    assert r is not None and r.ratio > 2.0 and r.step == 10
    # the outlier must not pollute the running mean
    assert abs(m.mean_step_time - 0.1) < 1e-6
    assert m.record(11, 0.11) is None
    assert len(m.reports) == 1


def test_straggler_monitor_warmup_no_flags():
    m = StragglerMonitor(threshold=1.5, warmup_steps=5)
    for i, d in enumerate([0.1, 0.9, 0.1, 0.7, 0.1]):
        assert m.record(i, d) is None
    assert not m.reports


BASE = dict(arch="qwen1.5-0.5b", device="cpu", method="es", meta_batch=8,
            minibatch=2, seq_len=16, n_samples=32, epochs=2, max_steps=4)


def test_sigterm_checkpoints_at_the_step_boundary_and_resumes_bitwise(
        tmp_path, capsys):
    """SIGTERM from a step hook after step 2: the step in flight (3)
    finishes, then the trainer writes its final checkpoint and stops;
    resumed from it to step 4, the losses and every leaf of the state are
    bitwise the uninterrupted run's."""
    trainers = []
    before = signal.getsignal(signal.SIGTERM)

    def trainer(**kw):
        tr = ttrain.Trainer(ttrain.TrainerConfig(**{**BASE, **kw}))
        trainers.append(tr)
        return tr

    try:
        ref = trainer()
        ref_out = ref.train()

        def sigterm_at_step_2(tr, epoch):
            if tr.global_step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        first = trainer(ckpt_dir=str(tmp_path))
        first.step_hooks.append(sigterm_at_step_2)
        out = first.train()
        assert first.preempt.preemption_requested
        assert out["steps"] == 3 and len(out["metrics"]) == 3
        assert "[preempt] checkpoint-and-exit" in capsys.readouterr().out
        assert first.ckpt.latest_step() == 3
        md = first.ckpt.manifest(3)["metadata"]
        assert md["global_step"] == 3 and md["data"]["step"] == 3

        res = trainer(ckpt_dir=str(tmp_path))
        assert res.global_step == 3
        res_out = res.train()
        assert [m["loss"] for m in res_out["metrics"]] == \
            [m["loss"] for m in ref_out["metrics"][3:]]
        for key in ("steps", "bp_samples_total", "scoring_steps_total"):
            assert res_out[key] == ref_out[key], key
        got = flatten(res.engine.state_dict(res.state))
        want = flatten(ref.engine.state_dict(ref.state))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    finally:
        for tr in reversed(trainers):      # give the signals back
            tr.preempt.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_summary_keys_are_a_superset_of_the_jax_trainers():
    """The JAX trainer's summary (a run of no epochs: nothing compiles)
    against the port's, with the straggler count and the store's sharding
    beside the port's own keys."""
    small = dict(arch="qwen1.5-0.5b", meta_batch=8, minibatch=2,
                 seq_len=16, n_samples=32, epochs=0)
    before = signal.getsignal(signal.SIGTERM)
    jtr = jtrain.Trainer(jtrain.TrainerConfig(**small))
    ttr = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **small))
    try:
        want, got = jtr.train(), ttr.train()
    finally:
        for tr in (ttr, jtr):
            tr.preempt.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert got["straggler_reports"] == want["straggler_reports"] == 0
    assert got["score_store_sharded"] is want["score_store_sharded"] is False
    assert {"device"} <= set(got) - set(want)
