"""PyTorch port: one serial-ES step (``ESEngine.es_step``) against JAX's.

qwen1.5 smoke at float32, the same converted parameters, the same batch
and the same non-trivial score store on both sides. The test draws the
Gumbel noise that JAX's step draws internally
(``jax.random.gumbel(jax.random.split(state.rng)[1], (B,), f32)``) and
injects it into the port's selection. Compared after the step: the
selected index SETS (``lax.top_k`` and ``torch.topk`` may order ties
differently), the parameters after AdamW, ``s``, ``w``, ``seen`` and the
cadence EMAs. Tolerance reached: 1e-5 (atol, rtol 1e-4) everywhere; the
integer leaves and the selected set are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fast_jit
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.core.engine import ESConfig, ESEngine, init_train_state
from repro.core.scores import ESScores
from repro.core.scores import weights_from_prev as jax_weights
from repro.core.selection import gumbel_topk_select
from repro.data.synthetic import SyntheticConfig, SyntheticLM
from repro.models.layers import ShardCtx
from repro.models.transformer import lm_per_sample_loss
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import engine as tengine
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.optim.schedule import get_schedule as t_get_schedule

B, b, N, S = 16, 4, 64, 32


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("method", ["es", "order"])
def test_es_step_matches_jax(method):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    es_cfg = ESConfig(method=method, minibatch=b, n_train=N, seq_chunk=0)
    opt_cfg = OptConfig(lr=1e-3)
    eng = ESEngine(cfg, es_cfg, opt_cfg, get_schedule("cosine", 16, 0),
                   ShardCtx())
    state = init_train_state(cfg, es_cfg, opt_cfg, jax.random.PRNGKey(0), B)
    rng = np.random.default_rng(5)
    s0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    seen0 = rng.integers(0, 3, N).astype(np.int32)
    state = dataclasses.replace(state, scores=ESScores(
        s=jnp.asarray(s0), w=jnp.asarray(w0), seen=jnp.asarray(seen0)))
    params0 = jax.device_get(state.params)
    ds = SyntheticLM(SyntheticConfig(n_samples=N, seq_len=S, vocab_size=64,
                                     seed=0))
    host = ds.batch(rng.permutation(N)[:B])
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    gumbel = np.asarray(jax.random.gumbel(jax.random.split(state.rng)[1],
                                          (B,), jnp.float32))

    # JAX's selection, rebuilt from the same pieces its step uses
    losses, _ = lm_per_sample_loss(cfg, state.params, jbatch, ShardCtx(),
                                   seq_chunk=0)
    wj = jax_weights(state.scores.s[jbatch["sample_ids"]], losses,
                     es_cfg.beta1)
    if method == "es":
        want_idx = gumbel_topk_select(jax.random.split(state.rng)[1], wj, b)
    else:
        want_idx = jax.lax.top_k(wj, b)[1]
    new, _ = fast_jit(eng.es_step)(state, jbatch)

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    t_es = tengine.ESConfig(method=method, minibatch=b, n_train=N)
    t_opt = TOptConfig(lr=1e-3)
    teng = tengine.ESEngine(tcfg, t_es, t_opt,
                            t_get_schedule("cosine", 16, 0))
    tstate = tengine.init_train_state(tcfg, t_es, t_opt, 0, "cpu",
                                      params=params_from_jax(params0))
    tstate.scores.s.copy_(torch.from_numpy(s0))
    tstate.scores.w.copy_(torch.from_numpy(w0))
    tstate.scores.seen.copy_(torch.from_numpy(seen0))
    tbatch = {k: torch.from_numpy(v) for k, v in host.items()}
    tstate, m = teng.es_step(tstate, tbatch,
                             gumbel=torch.from_numpy(gumbel.copy()))

    assert set(m["selected"].tolist()) == set(np.asarray(want_idx).tolist())
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
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(new.scores.seen))
    cad, jcad = tstate.cadence, new.cadence
    for name in ("drift_s", "drift_w", "since_prune"):
        np.testing.assert_allclose(float(getattr(cad, name)),
                                   float(getattr(jcad, name)), atol=1e-5,
                                   rtol=1e-4)
    assert cad.period == int(jcad.period)
    assert cad.last_scored == int(jcad.last_scored) == 0


def test_loss_and_grads_weight_grad_scale_as_jax():
    """The training mean is weighted by ``batch["grad_scale"]`` (the
    InfoBatch rescale) as JAX's ``_make_loss_fn`` weights it; without
    the key it is the plain mean. 1e-5 atol / 1e-4 rtol."""
    from _torch_parity import (_flat as pflat, host_batches, jax_batch,
                               make_pair, torch_batch)
    jeng, jstate, teng, tstate, rng = make_pair()
    host = host_batches(rng, 1)[0]
    host["grad_scale"] = rng.uniform(0.25, 2.0, B).astype(np.float32)
    (jmean, jper), jgrads = jeng._grad_fn(jstate.params, jax_batch(host))
    tmean, tper, tgrads = teng._loss_and_grads(tstate.params,
                                               torch_batch(host))
    np.testing.assert_allclose(float(tmean), float(jmean), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), atol=1e-5,
                               rtol=1e-4)
    got, want = pflat(params_to_numpy(tgrads)), pflat(jgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    del host["grad_scale"]
    plain, per, _ = teng._loss_and_grads(tstate.params, torch_batch(host))
    torch.testing.assert_close(plain, per.mean())
    assert abs(float(plain) - float(tmean)) > 1e-3
