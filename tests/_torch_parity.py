"""Shared set-up of the port's tests: one JAX ``ESEngine`` and one port
``ESEngine`` on qwen1.5 smoke at float32, the same converted parameters
and the same non-trivial score store, the helpers that draw JAX's
selection noise and compare the two states, and ``one_torch_thread``,
which every port test module imports."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config
from repro.core import engine as jengine
from repro.core import frequency as jfrequency
from repro.core.scores import ESScores
from repro.data.synthetic import SyntheticConfig, SyntheticLM
from repro.models.layers import ShardCtx
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import engine as tengine
from repro_torch.core import frequency as tfrequency
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.optim.schedule import get_schedule as t_get_schedule

B, b, N, S = 16, 4, 64, 32
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the importing test module, restored
    after it. The tests run smoke shapes, where the pool only contends:
    the suite runs in parallel worker processes on the CPU, and there
    each process's spinning pool threads slowed a smoke trainer's run
    from under a second to a minute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfg():
    return dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                               compute_dtype="float32")


def make_pair(method="es", freq=None, cadence=None, seed=5):
    """-> (jax engine, jax state, port engine, port state, rng).
    ``freq`` and ``cadence`` are keyword dicts of ``FreqSchedule`` and
    ``CadenceConfig``, built on each side."""
    cfg = smoke_cfg()
    es_cfg = jengine.ESConfig(method=method, minibatch=b, n_train=N,
                              seq_chunk=0)
    opt_cfg = OptConfig(lr=1e-3)
    jfreq = jfrequency.FreqSchedule(**freq) if freq else None
    jcad = jengine.CadenceConfig(**cadence) if cadence else None
    jeng = jengine.ESEngine(cfg, es_cfg, opt_cfg,
                            get_schedule("cosine", 16, 0), ShardCtx(),
                            freq=jfreq, cadence=jcad)
    jstate = jengine.init_train_state(cfg, es_cfg, opt_cfg,
                                      jax.random.PRNGKey(0), B)
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    seen0 = rng.integers(0, 3, N).astype(np.int32)
    jstate = dataclasses.replace(jstate, scores=ESScores(
        s=jnp.asarray(s0), w=jnp.asarray(w0), seen=jnp.asarray(seen0)))

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    t_es = tengine.ESConfig(method=method, minibatch=b, n_train=N)
    t_opt = TOptConfig(lr=1e-3)
    tfreq = tfrequency.FreqSchedule(**freq) if freq else None
    tcad = tengine.CadenceConfig(**cadence) if cadence else None
    teng = tengine.ESEngine(tcfg, t_es, t_opt,
                            t_get_schedule("cosine", 16, 0), freq=tfreq,
                            cadence=tcad)
    tstate = tengine.init_train_state(
        tcfg, t_es, t_opt, 0, "cpu", meta_batch=B,
        params=params_from_jax(jax.device_get(jstate.params)))
    tstate.scores.s.copy_(torch.from_numpy(s0))
    tstate.scores.w.copy_(torch.from_numpy(w0))
    tstate.scores.seen.copy_(torch.from_numpy(seen0))
    return jeng, jstate, teng, tstate, rng


def host_batches(rng, count):
    """``count`` meta-batches of B random sample ids from the JAX package's
    synthetic data."""
    ds = SyntheticLM(SyntheticConfig(n_samples=N, seq_len=S, vocab_size=64,
                                     seed=0))
    return [ds.batch(rng.permutation(N)[:B]) for _ in range(count)]


def jax_batch(host):
    return {k: jnp.asarray(v) for k, v in host.items()}


def torch_batch(host):
    return {k: torch.from_numpy(v.copy()) for k, v in host.items()}


def jax_gumbel(jstate):
    """The selection noise JAX's next step draws from its state."""
    key = jax.random.split(jstate.rng)[1]
    return torch.from_numpy(np.asarray(
        jax.random.gumbel(key, (B,), jnp.float32)).copy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_cadence_close(tcad, jcad):
    for name in ("drift_s", "drift_w", "since_prune"):
        np.testing.assert_allclose(float(getattr(tcad, name)),
                                   float(getattr(jcad, name)), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    assert tcad.period == int(jcad.period)
    assert tcad.last_scored == int(jcad.last_scored)


def assert_state_close(tstate, jstate):
    """Parameters, store, cadence and step of the two states."""
    assert tstate.opt.step == int(jstate.opt.step)
    got, want = _flat(params_to_numpy(tstate.params)), _flat(jstate.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    for name in ("s", "w"):
        np.testing.assert_allclose(getattr(tstate.scores, name).numpy(),
                                   np.asarray(getattr(jstate.scores, name)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(jstate.scores.seen))
    assert_cadence_close(tstate.cadence, jstate.cadence)
