"""PyTorch port: the trainer end to end against the JAX ``Trainer``.

qwen1.5 smoke at float32, meta-batch 16, minibatch 4, seq 32, 64 samples,
8 steps, the port started from the JAX trainer's converted initial
parameters. ``baseline`` (b >= B) and ``order`` (deterministic top-k) have
no randomness inside the step, so the loss trajectories must agree. The
tolerance is 1e-3 relative: per-step losses agree to ~1e-6 at step 1, and
8 AdamW steps amplify float32 differences in sums taken in another order
(XLA's fusions against PyTorch's kernels) without reaching 1e-4.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.launch import train as ttrain

COMMON = dict(arch="qwen1.5-0.5b", smoke=True, meta_batch=16, minibatch=4,
              seq_len=32, n_samples=64, max_steps=8)


@pytest.mark.parametrize("method", ["baseline", "order"])
def test_loss_trajectory_matches_jax_trainer(method):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    jt = JaxTrainer(JaxTrainerConfig(method=method, **COMMON), model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    want = [r["loss"] for r in jt.train()["metrics"]]

    tt = ttrain.Trainer(
        ttrain.TrainerConfig(method=method, device="cpu", **COMMON),
        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
        init_params=params_from_jax(params0))
    out = tt.train()
    got = [r["loss"] for r in out["metrics"]]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert out["steps"] == 8
    assert out["bp_samples_total"] == (128.0 if method == "baseline"
                                       else 32.0)
    assert out["scoring_steps_total"] == (0.0 if method == "baseline"
                                          else 8.0)


@pytest.mark.parametrize("k", [1, 2])
def test_es_cli_runs_on_cpu(k, capsys):
    """Serial ES (k=1) and the fixed decimated schedule (k=2: the scoring
    forward runs on steps 0 and 2, the stale weights select in between)."""
    out = ttrain.main(["--arch", "qwen1.5-0.5b", "--method", "es",
                       "--meta-batch", "16", "--minibatch", "4",
                       "--seq-len", "32", "--n-samples", "64",
                       "--max-steps", "4", "--device", "cpu",
                       "--score-every", str(k)])
    losses = [r["loss"] for r in out["metrics"]]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert [r["scored"] for r in out["metrics"]] == \
        [float(t % k == 0) for t in range(4)]
    summary = json.loads(capsys.readouterr().out)
    assert summary["steps"] == 4 and summary["scoring_steps_total"] == 4 / k
    assert summary["bp_samples_total"] == 16.0
    assert {"final_loss", "wall_time"} <= set(summary)


@pytest.mark.parametrize("flags,scored,bp", [
    (["--pack", "--max-segments", "4", "--minibatch", "6"], 0.0, 18.0),
    (["--quant-scores", "--quant-block", "16", "--minibatch", "2"], 1.0,
     6.0)])
def test_pack_and_quant_cli_run_on_cpu(flags, scored, bp, capsys):
    """Packed token-level ES (the store holds documents, the sampler walks
    rows; scoring rides the training forward) and serial ES over the int8
    store."""
    out = ttrain.main(["--arch", "qwen1.5-0.5b", "--method", "es",
                       "--meta-batch", "4", "--seq-len", "32",
                       "--n-samples", "48", "--max-steps", "3",
                       "--device", "cpu", *flags])
    losses = [r["loss"] for r in out["metrics"]]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    summary = json.loads(capsys.readouterr().out)
    assert summary["steps"] == 3
    assert summary["scoring_steps_total"] == 3 * scored
    assert summary["bp_samples_total"] == bp


def test_packed_trainer_sizes_store_by_documents():
    tr = ttrain.Trainer(ttrain.TrainerConfig(
        arch="qwen1.5-0.5b", device="cpu", pack=True, meta_batch=4,
        minibatch=4, seq_len=32, n_samples=48, max_steps=1))
    assert tr.doc_level and tr.tc.source == "packed"
    assert tr.n_train == 48 == tr.state.scores.s.shape[0]
    assert tr.planned_steps_per_epoch() == len(tr.ds) // 4 < 48 // 4
    tr.train()
    assert int(tr.state.scores.seen.sum()) > 4


def test_default_device_raises_without_gpu():
    if ttrain.torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.Trainer(ttrain.TrainerConfig(**COMMON))


def test_cuda_rejects_max_segments_beyond_kernel():
    """The segment-sum kernel holds at most MAX_SEGMENTS slots; a CUDA
    trainer refuses more before it builds the model and the store."""
    from repro_torch.kernels.segsum.ops import MAX_SEGMENTS
    with pytest.raises(ValueError, match="--max-segments"):
        ttrain.main(["--device", "cuda", "--pack", "--max-segments",
                     str(MAX_SEGMENTS + 1)])


@pytest.mark.parametrize("flags", [["--pipelined"], ["--shard-scores"],
                                   ["--quant-scores", "--quant-wire"],
                                   ["--source", "tokens"],
                                   ["--ckpt-dir", "x"], ["--method", "eswp"],
                                   ["--freq-schedule", "drift"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        ttrain.main(["--device", "cpu", *flags])
