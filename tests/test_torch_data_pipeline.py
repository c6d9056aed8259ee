"""PyTorch port: the data pipeline against the JAX package.

The prefetcher's contract (order parity with the synchronous stream,
bounded backpressure, clean shutdown mid-stream, worker errors re-raised
in the consumer, no leaked threads; ``tests/test_pipeline.py:125-183``),
on the CPU placer; every wait here times out within seconds. Then
``DataPipeline.epoch`` against JAX's (the same ids and arrays, synthetic
and packed), the trainer with prefetch on and off (bitwise-equal losses),
and ``Trainer.eval_mean_loss`` against the JAX trainer's on the same
parameters (1e-5 relative: the kernels' plain versions against XLA's
float32 sums).
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_parity import smoke_cfg
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PackedSource as JaxPacked
from repro.data.pipeline import SyntheticSource as JaxSynthetic
from repro.data.synthetic import SyntheticConfig as JaxSynthConfig
from repro.data.synthetic import SyntheticLM as JaxSynthLM
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.data.pipeline import (CudaPlacer, DataPipeline, HostPlacer,
                                       PackedSource, Prefetcher, SyncStream,
                                       SyntheticSource, make_placer)
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.launch import train as ttrain

WAIT_S = 3.0


def _host_batches(n):
    for i in range(n):
        yield {"x": np.full((4,), i, np.int32)}


def _next(stream):
    """next() on a stream, bounded by WAIT_S (a hung worker fails the
    test instead of hanging it); what next() raises re-raises here."""
    out = {}

    def call():
        try:
            out["v"] = next(stream)
        except BaseException as e:        # handed to the test thread
            out["err"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive(), "next() did not return"
    if "err" in out:
        raise out["err"]
    return out["v"]


def test_prefetcher_order_parity_with_sync():
    sync = [b["x"] for b in SyncStream(_host_batches(7), place=HostPlacer())]
    with Prefetcher(_host_batches(7), place=HostPlacer()) as pf:
        pre = [_next(pf)["x"] for _ in range(7)]
        with pytest.raises(StopIteration):
            next(pf)
    assert len(sync) == len(pre) == 7
    for a, b in zip(sync, pre):
        assert isinstance(b, torch.Tensor)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefetcher_backpressure_is_bounded():
    built = []

    def batches():
        for i in range(16):
            built.append(i)
            yield {"x": np.asarray([i])}

    with Prefetcher(batches(), depth=2, place=HostPlacer()) as pf:
        _next(pf)
        time.sleep(0.3)          # let the worker run ahead if it could
        # consumed 1; the worker may hold 2 queued + 1 in its build
        assert len(built) <= 1 + 2 + 1, built
        rest = [_next(pf) for _ in range(15)]
    assert [int(r["x"]) for r in rest] == list(range(1, 16))


def test_prefetcher_clean_shutdown_mid_stream():
    pf = Prefetcher(_host_batches(100), depth=2, place=HostPlacer())
    _next(pf)
    pf.close()                   # early stop with a full queue
    pf._thread.join(timeout=WAIT_S)
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                   # idempotent


def test_prefetcher_propagates_worker_exception():
    def bad_batches():
        yield {"x": np.asarray([0])}
        raise RuntimeError("source exploded")

    with Prefetcher(bad_batches(), place=HostPlacer()) as pf:
        _next(pf)
        with pytest.raises(RuntimeError, match="source exploded"):
            _next(pf)


def test_prefetcher_threads_do_not_leak():
    before = threading.active_count()
    for _ in range(5):
        with Prefetcher(_host_batches(3), place=HostPlacer()) as pf:
            list(pf)
    assert threading.active_count() <= before


def test_prefetchers_under_thread_stress_keep_order():
    """More prefetchers than cores, the interpreter switching threads
    every microsecond: each consumer still sees its own batches once, in
    order, and every worker is joined."""
    import os
    import sys
    n = 2 * (os.cpu_count() or 4)
    got = [[] for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def consume(i):
            with Prefetcher(({"x": np.asarray([i, j])} for j in range(50)),
                            depth=2, place=HostPlacer()) as pf:
                got[i] = [tuple(b["x"].tolist()) for b in pf]
                pf._thread.join(timeout=WAIT_S)
                assert not pf._thread.is_alive()

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10 * WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == [[(i, j) for j in range(50)] for i in range(n)]


def test_placer_follows_device():
    assert isinstance(make_placer("cpu"), HostPlacer)
    with pytest.raises(ValueError):
        CudaPlacer("cpu")


def _sources(kind):
    if kind == "synthetic":
        kw = dict(n_samples=64, seq_len=32, vocab_size=64, seed=3)
        return (JaxSynthetic(JaxSynthLM(JaxSynthConfig(**kw))),
                SyntheticSource(SyntheticLM(SyntheticConfig(**kw))))
    kw = dict(seq_len=32, max_segments=4, vocab=64, seed=3)
    return JaxPacked.synthetic(96, **kw), PackedSource.synthetic(96, **kw)


@pytest.mark.parametrize("kind", ["synthetic", "packed"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_pipeline_epoch_matches_jax(kind, prefetch):
    jsrc, tsrc = _sources(kind)
    jp = JaxPipeline(jsrc, 8, seed=1, prefetch=False, place=lambda b: b)
    tp = DataPipeline(tsrc, 8, seed=1, prefetch=prefetch,
                      place=HostPlacer())
    assert tp.doc_level == jp.doc_level == (kind == "packed")
    assert tp.steps_per_epoch(0) == jp.steps_per_epoch(0) > 1
    for epoch in range(2):
        with jp.epoch(epoch, 1) as js, tp.epoch(epoch, 1) as ts:
            got, want = list(ts), list(js)
        assert len(got) == len(want) == jp.steps_per_epoch(epoch) - 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
        for k, v in jp.batch_at(epoch, 2).items():
            np.testing.assert_array_equal(tp.batch_at(epoch, 2)[k], v)


COMMON = dict(arch="qwen1.5-0.5b", smoke=True, meta_batch=16, minibatch=4,
              seq_len=32, n_samples=64, device="cpu")


@pytest.mark.parametrize("pipelined", [False, True])
def test_trainer_no_prefetch_matches_prefetch(pipelined):
    """Prefetch changes when a batch is built, never which: the loss
    trajectories are bitwise equal."""
    outs = [ttrain.Trainer(ttrain.TrainerConfig(
        method="es", epochs=2, pipelined=pipelined, prefetch=p,
        **COMMON)).train() for p in (True, False)]
    a, b = ([m["loss"] for m in o["metrics"]] for o in outs)
    assert len(a) == 8 and a == b
    assert all(m["data_wait"] >= 0.0 for m in outs[0]["metrics"])


def test_eval_mean_loss_matches_jax_trainer():
    cfg = smoke_cfg()
    kw = {k: v for k, v in COMMON.items() if k != "device"}
    jt = JaxTrainer(JaxTrainerConfig(method="es", **kw), model_cfg=cfg)
    want = jt.eval_mean_loss(n=40, batch=16)      # 16 + 16 + 8 padded
    tt = ttrain.Trainer(
        ttrain.TrainerConfig(method="es", **COMMON),
        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
        init_params=params_from_jax(jax.device_get(jt.state.params)))
    got = tt.eval_mean_loss(n=40, batch=16)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tt.tc = dataclasses.replace(tt.tc, prefetch=False)
    assert tt.eval_mean_loss(n=40, batch=16) == got
