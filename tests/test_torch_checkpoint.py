"""PyTorch port: checkpoints and resume.

* ``Checkpointer``: round trip (float32, bf16, int8 and a generator's
  uint8 state, exact), async save and ``wait`` (also re-raising a writer's
  error), keep-k, no ``.tmp`` left, an atomic overwrite of a step, the
  latest step by default, a leaf the checkpoint lacks, a leaf of another
  shape (raises), the extras channel and the manifest (as ``tests/test_checkpoint.py`` holds the reference's);
* the port's trainer killed mid-epoch and resumed against an uninterrupted
  run on the CPU: the tail's losses, the final parameters, optimizer
  moments and score store bitwise equal, for serial ES, pipelined ES with
  a held batch, the int8 store, packed ES and the drift cadence (as
  ``tests/test_pipeline.py:347-380`` holds the reference's trainer);
* a resume whose seed, meta-batch, ``drop_last`` or source differs, or
  whose cursor names a kept-set, raises;
* the port's manifest against the JAX trainer's on the same run (qwen1.5
  smoke at float32, method ``order``, pipelined, from the same converted
  parameters): the same metadata keys and the same values of the step,
  epoch, counters, data cursor and cadence (its EMAs within 1e-3
  relative, the trajectories' tolerance in ``test_torch_train.py``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.registry import get_smoke_config
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ModelConfig
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import tree_leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "h": torch.randn(3, generator=g).bfloat16()},
            "codes": torch.randint(-127, 128, (16,), generator=g,
                                   dtype=torch.int8),
            "step": torch.tensor(7 + seed, dtype=torch.int64),
            "generator": g.get_state()}


def _equal(a, b):
    for (ka, x), (kb, y) in zip(sorted(_leaves(a)), sorted(_leaves(b))):
        assert ka == kb
        assert x.dtype == y.dtype, ka
        assert torch.equal(x, y), ka


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _leaves(v, f"{prefix}{k}/")]
    return [(prefix, tree)]


def test_roundtrip_extras_and_manifest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    ck.save(state, step=7, metadata={"epoch": 1},
            extras={"kept": np.arange(5), "mask": np.ones(3, np.int8)})
    _equal(ck.restore(_state(seed=9), step=7), state)
    ex = ck.extras(7)
    np.testing.assert_array_equal(ex["kept"], np.arange(5))
    assert ex["mask"].dtype == np.int8
    man = ck.manifest(7)
    assert man["step"] == 7 and man["metadata"] == {"epoch": 1}
    assert man["leaves"]["params/h"] == {"shape": [3], "dtype": "bfloat16"}
    assert man["leaves"]["extra/kept"]["shape"] == [5]


def test_restore_casts_keeps_absent_leaves_checks_shapes(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save({"a": torch.arange(4, dtype=torch.float32)}, step=1)
    got = ck.restore({"a": torch.zeros(4, dtype=torch.bfloat16),
                      "new": torch.full((2,), 5.0)})
    assert got["a"].dtype == torch.bfloat16
    assert got["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got["new"].tolist() == [5.0, 5.0]
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.zeros(5)})


def test_async_save_and_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state()
    ck.save_async(state, step=3)
    state["params"]["w"].add_(1.0)      # the snapshot was taken already
    ck.wait()
    assert ck.latest_step() == 3
    assert [t["op"] for t in ck.timings] == ["snapshot", "write"]
    assert ck.timings[1]["bytes"] > 0
    _equal(ck.restore(_state(seed=1), step=3)["params"],
           _state()["params"])


def test_wait_reraises_writer_error(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(_state(), step=1, metadata={"bad": object()})
    with pytest.raises(TypeError):
        ck.wait()
    ck.wait()                            # raised once


def test_keep_k_gc_and_no_tmp_left(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(_state(s), step=s)
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert not any(p.name.endswith(".tmp") for p in ck.dir.iterdir())
    _equal(ck.restore(_state(0)), _state(4))


def test_overwrite_same_step_is_atomic(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(_state(1), step=5)
    ck.save(_state(2), step=5)
    assert ck.all_steps() == [5]
    _equal(ck.restore(_state(0), step=5), _state(2))


# ---------------------------------------------------------------------------
# the trainer: kill mid-epoch, resume, compare with the uninterrupted run
# ---------------------------------------------------------------------------

BASE = dict(arch="qwen1.5-0.5b", device="cpu", method="es", meta_batch=8,
            minibatch=2, seq_len=16, n_samples=32, epochs=2)

RESUMES = {
    "serial": (dict(), 3),
    # stops with a held batch, mid-epoch 0
    "pipelined_held": (dict(pipelined=True), 3),
    "int8_store": (dict(quant_scores=True, quant_block=8), 5),
    "packed": (dict(pack=True, minibatch=6, n_samples=96), 3),
    "drift": (dict(freq_schedule="drift", score_every=4), 5),
}


def _tc(**kw):
    return ttrain.TrainerConfig(**{**BASE, **kw})


@pytest.mark.parametrize("case", list(RESUMES))
def test_mid_epoch_resume_bit_exact(case, tmp_path):
    kw, stop_at = RESUMES[case]
    ref = ttrain.Trainer(_tc(max_steps=7, **kw))
    ref_out = ref.train()
    ttrain.Trainer(_tc(max_steps=stop_at, ckpt_dir=str(tmp_path),
                       **kw)).train()
    res = ttrain.Trainer(_tc(max_steps=7, ckpt_dir=str(tmp_path), **kw))
    assert res.global_step == stop_at
    if case == "pipelined_held":
        assert res._resume_held
    out = res.train()
    assert [m["loss"] for m in out["metrics"]] == \
        [m["loss"] for m in ref_out["metrics"][stop_at:]]
    for key in ("steps", "bp_samples_total", "scoring_steps_total"):
        assert out[key] == ref_out[key], key
    want = ref.engine.state_dict(ref.state)
    got = res.engine.state_dict(res.state)
    _equal(got, want)
    assert res.ckpt.latest_step() == 7


def test_cli_ckpt_dir_resumes(tmp_path, capsys):
    args = ["--arch", "qwen1.5-0.5b", "--meta-batch", "8", "--minibatch",
            "2", "--seq-len", "16", "--n-samples", "32", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    first = ttrain.main(args + ["--max-steps", "2"])
    second = ttrain.main(args + ["--max-steps", "3"])
    assert [r["step"] for r in first["metrics"]] == [1, 2]
    assert [r["step"] for r in second["metrics"]] == [3]
    assert "[resume] step=2 epoch=0 epoch_step=2" in capsys.readouterr().out


@pytest.mark.parametrize("change", [
    dict(seed=1), dict(meta_batch=4), dict(drop_last=False),
    dict(n_samples=40), "kept_digest"])
def test_resume_cursor_mismatch_raises(change, tmp_path):
    ttrain.Trainer(_tc(max_steps=2, ckpt_dir=str(tmp_path))).train()
    if change == "kept_digest":
        ck = Checkpointer(tmp_path)
        path = ck.step_dir(2) / "manifest.json"
        man = json.loads(path.read_text())
        man["metadata"]["data"]["kept_digest"] = "0123456789abcdef"
        path.write_text(json.dumps(man))
        change = {}
    with pytest.raises(ValueError, match="resume"):
        ttrain.Trainer(_tc(max_steps=4, ckpt_dir=str(tmp_path), **change))


def test_manifest_metadata_matches_jax_trainer(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    common = dict(arch="qwen1.5-0.5b", method="order", meta_batch=16,
                  minibatch=4, seq_len=32, n_samples=64, max_steps=6,
                  pipelined=True)
    jt = JaxTrainer(JaxTrainerConfig(ckpt_dir=str(tmp_path / "jax"),
                                     **common), model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    jt.train()
    tt = ttrain.Trainer(
        ttrain.TrainerConfig(device="cpu", ckpt_dir=str(tmp_path / "port"),
                             **common),
        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
        init_params=params_from_jax(params0))
    tt.train()
    want = JaxCheckpointer(tmp_path / "jax").manifest()["metadata"]
    got = Checkpointer(tmp_path / "port").manifest()["metadata"]
    assert set(got) == set(want)
    for key in ("global_step", "epoch", "bp_samples_total",
                "scoring_steps_total", "epochs_since_prune", "method",
                "score_store", "data"):
        assert got[key] == want[key], key
    # 6 steps of 4 an epoch: mid-epoch 1 with a held batch
    assert got["data"]["held"] and got["data"]["step"] == 3
    gc, wc = got["cadence"], want["cadence"]
    assert set(gc) == set(wc)
    assert (gc["kind"], gc["period"]) == (wc["kind"], wc["period"])
    for k in ("drift_s", "drift_w", "since_prune"):
        assert gc[k] == pytest.approx(wc[k], rel=1e-3), k
    assert len(tree_leaves(tt.state.params)) == len(jax.tree.leaves(
        jt.state.params))
