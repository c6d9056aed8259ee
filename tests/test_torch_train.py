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

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.launch import train as ttrain

COMMON = dict(arch="qwen1.5-0.5b", smoke=True, meta_batch=16, minibatch=4,
              seq_len=32, n_samples=64, max_steps=8)


TRAJECTORIES = {
    "baseline": ("baseline", {}),
    "order": ("order", {}),
    # pipelined ES: a prime and a flush an epoch (4 steps an epoch)
    "order-pipelined": ("order", {"pipelined": True}),
    # the drift servo decides which steps score, capped at period 8
    "order-drift": ("order", {"freq_schedule": "drift", "score_every": 8}),
}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_loss_trajectory_matches_jax_trainer(case):
    method, extra = TRAJECTORIES[case]
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    jt = JaxTrainer(JaxTrainerConfig(method=method, **extra, **COMMON),
                    model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    jout = jt.train()
    want = [r["loss"] for r in jout["metrics"]]

    tt = ttrain.Trainer(
        ttrain.TrainerConfig(method=method, device="cpu", **extra, **COMMON),
        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
        init_params=params_from_jax(params0))
    out = tt.train()
    got = [r["loss"] for r in out["metrics"]]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert out["steps"] == 8
    assert [r["scored"] for r in out["metrics"]] == \
        [r["scored"] for r in jout["metrics"]]
    assert out["bp_samples_total"] == jout["bp_samples_total"] == (
        128.0 if method == "baseline" else 32.0)
    assert out["scoring_steps_total"] == jout["scoring_steps_total"] == (
        0.0 if method == "baseline" else
        8.0 if case in ("order", "order-pipelined") else
        jout["scoring_steps_total"])


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


# the file sources and host slicing are ported (tests/test_torch_sources.py),
# and --grad-compression and the moe/ssm/hybrid families
# (tests/test_torch_compression.py, tests/test_torch_families.py)
@pytest.mark.parametrize("flags", [["--shard-scores", "--pipelined"],
                                   ["--shard-scores"],
                                   ["--quant-scores", "--quant-wire"],
                                   ["--shard-scores", "--quant-scores"],
                                   ["--arch", "llama-3.2-vision-11b"],
                                   ["--arch", "seamless-m4t-large-v2"],
                                   ["--method", "grad-norm"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        ttrain.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("flags,scored", [
    (["--pipelined"], [1.0, 1.0, 1.0, 0.0]),
    (["--freq-schedule", "fixed", "--score-every", "2"],
     [1.0, 0.0, 1.0, 0.0]),
    (["--freq-schedule", "warmup", "--score-every", "4"],
     [1.0, 1.0, 1.0, 0.0]),
    # the passband search picks period 3 of the cap of 8
    (["--freq-schedule", "adaptive", "--score-every", "8",
      "--gain-floor", "0.3"], [1.0, 0.0, 0.0, 1.0]),
    # a target far above the drift: the servo doubles the period at
    # each firing (1 -> 2 -> 4)
    (["--freq-schedule", "drift", "--drift-target", "100",
      "--no-prefetch", "--prefetch-depth", "3"], [1.0, 0.0, 1.0, 0.0])])
def test_cadence_and_pipelined_cli_run_on_cpu(flags, scored):
    """The pipelined session (a prime, three pipelined steps and the
    flush of the epoch's held batch; the prime's scoring is counted) and
    the four scoring cadences, 4 steps each."""
    out = ttrain.main(["--arch", "qwen1.5-0.5b", "--method", "es",
                       "--meta-batch", "16", "--minibatch", "4",
                       "--seq-len", "32", "--n-samples", "64",
                       "--max-steps", "4", "--device", "cpu", *flags])
    got = [r["scored"] for r in out["metrics"]]
    assert out["steps"] == 4 and len(got) == 4
    assert np.all(np.isfinite([r["loss"] for r in out["metrics"]]))
    assert got == scored
    primes = 1.0 if "--pipelined" in flags else 0.0
    assert out["scoring_steps_total"] == sum(got) + primes
