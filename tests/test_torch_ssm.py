"""PyTorch port: the Mamba2 / SSD block (``repro_torch/models/ssm.py``)
against the JAX package's ``repro/models/ssm.py``, at float32.

* ``ssd_chunked`` with and without an initial state, S a multiple of the
  chunk and not (dt = 0 padding), against JAX's: y and the final state at
  atol 1e-5, rtol 1e-4. The port's inter-chunk recurrence is a loop over
  the chunks where the reference runs ``associative_scan``: the same
  values in another float order;
* ``mamba2_fwd`` with ``return_state`` from JAX's parameters: the output
  and the decode cache (final state, the pre-conv tails) at the same
  tolerance;
* ``mamba2_decode`` token by token against the port's full forward and
  final state, at ``tests/test_decode.py:80``'s atol 2e-4, rtol 1e-3, and
  each step against JAX's ``mamba2_decode`` at atol 1e-5, rtol 1e-4;
* ``init_mamba2``'s tree and ``A_log`` = log(1..nh) as the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fast_jit, one_torch_thread  # noqa: F401
from repro.models import ssm as jssm
from repro.models.layers import ShardCtx
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Init

CTX = ShardCtx()
ATOL, RTOL = 1e-5, 1e-4
# LLVM's backend optimisations off for the references' jits: a third of
# the compile time, the same HLO (the arithmetic)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


D, N, P, EXPAND, W = 32, 16, 8, 2, 4     # d_model, state, head dim, conv


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("S,chunk,with_state", [(32, 8, False),
                                                (32, 8, True),
                                                (27, 8, False),
                                                (27, 16, True)])
def test_ssd_chunked_matches_jax(S, chunk, with_state):
    B, H = 2, 3
    x = _np((B, S, H, P), 0)
    dt = np.log1p(np.exp(_np((B, S, H), 1)))          # softplus'ed
    A = -np.exp(_np((H,), 2, 0.5))
    Bm, Cm = _np((B, S, N), 3, 0.5), _np((B, S, N), 4, 0.5)
    st = _np((B, H, P, N), 5, 0.3) if with_state else None
    want_y, want_s = _jit(
        lambda *a: jssm.ssd_chunked(*a[:5], chunk, init_state=a[5]),
        *(jnp.asarray(v) for v in (x, dt, A, Bm, Cm)),
        None if st is None else jnp.asarray(st))
    got_y, got_s = tssm.ssd_chunked(
        *(torch.from_numpy(v) for v in (x, dt, A, Bm, Cm)), chunk,
        init_state=None if st is None else torch.from_numpy(st))
    assert got_y.shape == (B, S, H, P) and got_s.dtype == torch.float32
    _close(got_y, want_y, "y")
    _close(got_s, want_s, "final state")


def _params(seed=1):
    p = _jit(lambda k: jssm.init_mamba2(k, D, state=N, head_dim=P,
                                        expand=EXPAND, conv_width=W)[0],
             jax.random.PRNGKey(seed))
    return p, {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in p.items()}


def test_init_tree_and_a_log_as_jax():
    p, _ = _params()
    own = tssm.init_mamba2(D, state=N, head_dim=P, expand=EXPAND,
                           conv_width=W, lead=(3,), init=Init(
                               "cpu", torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape[1:]) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in p.items()}
    np.testing.assert_allclose(own["A_log"][2].numpy(),
                               np.asarray(p["A_log"]), rtol=1e-6)


@pytest.mark.parametrize("S", [24, 21])
def test_mamba2_fwd_with_state_matches_jax(S):
    p, tp = _params()
    x = _np((2, S, D), 6, 0.5)
    kw = dict(state=N, head_dim=P, expand=EXPAND)
    want, wcache = _jit(lambda pp, xx: jssm.mamba2_fwd(
        pp, xx, chunk=8, ctx=CTX, return_state=True, **kw), p,
        jnp.asarray(x))
    got, gcache = tssm.mamba2_fwd(tp, torch.from_numpy(x), chunk=8,
                                  return_state=True, **kw)
    _close(got, want, "y")
    assert set(gcache) == set(wcache)
    for k in wcache:
        assert gcache[k].dtype == torch.float32
        _close(gcache[k], wcache[k], k)


def test_decode_steps_match_full_forward_and_jax():
    p, tp = _params(2)
    B, S = 2, 20
    x = _np((B, S, D), 7, 0.5)
    kw = dict(state=N, head_dim=P, expand=EXPAND)
    full, fcache = tssm.mamba2_fwd(tp, torch.from_numpy(x), chunk=8,
                                   return_state=True, **kw)
    cache = tssm.init_ssm_cache(B, D, conv_width=W, device="cpu", **kw)
    jcache = jssm.init_ssm_cache(B, D, conv_width=W, **kw)
    jdecode = fast_jit(lambda pp, xx, c: jssm.mamba2_decode(
        pp, xx, c, ctx=CTX, **kw))
    ys = []
    for t in range(S):
        y, cache = tssm.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      cache, **kw)
        jy, jcache = jdecode(p, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy, f"step {t}")
        ys.append(y)
    for k in jcache:
        _close(cache[k], jcache[k], k)
    _close(torch.cat(ys, dim=1), full.numpy(), "recurrent vs chunked",
           atol=2e-4, rtol=1e-3)
    _close(cache["ssm_state"], fcache["ssm_state"].numpy(), "state",
           atol=2e-4, rtol=1e-3)
