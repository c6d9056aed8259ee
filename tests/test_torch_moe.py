"""PyTorch port: the MoE dispatch (``repro_torch/models/moe.py``) against
the JAX package's ``repro/models/moe.py``.

* ``capacity`` equal to the reference's over a grid (integers, exact);
* routing on the same float32 logits: the expert ids, the slots and the
  keep mask integer-equal to the reference's expressions
  (``moe.py:109-120``) and the gates to float32 rounding (rtol 1e-6: the
  softmax's exp and sum in another order); ties go to the lower expert
  index, as ``jax.lax.top_k`` orders them, so no draw has to avoid ties;
* ``moe_fwd`` (global and grouped dispatch, tight and dropless capacity)
  and its gradients with respect to x and every weight, at float32
  against JAX's from the same parameters: atol 1e-5, rtol 1e-4 (matmuls
  in another float order); grouped dispatch equal to global when
  dropless, as ``tests/test_moe.py:33`` holds the reference;
* a capacity-starved dispatch leaves dropped tokens exactly zero, in the
  same rows as the reference;
* ``moe_aux_loss`` against JAX's at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.models import moe as jmoe
from repro.models.layers import ShardCtx
from repro_torch.models import moe as tmoe

CTX = ShardCtx()
ATOL, RTOL = 1e-5, 1e-4
# LLVM's backend optimisations off for the references' jits: a third of
# the compile time, the same HLO (the arithmetic)
FAST = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _params(d=32, f=48, E=8, seed=0):
    p, _ = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, E)
    return p, {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_capacity_matches_jax_on_a_grid():
    for T in (1, 4, 8, 63, 64, 100, 1024, 4096, 16384):
        for E in (2, 4, 8, 128):
            for k in (1, 2):
                for cf in (0.25, 1.0, 1.25, 8.0, float(E)):
                    assert tmoe.capacity(T, E, k, cf) == \
                        jmoe.capacity(T, E, k, cf), (T, E, k, cf)


def _jax_route(logits, k, C):
    """The reference's routing expressions (``moe.py:109-120``)."""
    G, Tg, E = logits.shape
    gates, eidx = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(gates, axis=-1)
    flat_e = eidx.reshape(G, Tg * k)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=1) - oh
    pos_in_e = jnp.sum(pos * oh, axis=-1)
    keep = pos_in_e < C
    slot = jnp.where(keep, flat_e * C + pos_in_e, E * C)
    return gates, eidx, slot, keep


@pytest.mark.parametrize("G,Tg,E,k,C", [(1, 64, 8, 2, 16), (2, 32, 4, 2, 8),
                                        (1, 40, 128, 2, 8),
                                        (4, 16, 8, 1, 8)])
def test_routing_integers_equal_jax(G, Tg, E, k, C):
    logits = _x((G, Tg, E), seed=E + k)
    want = _jit(lambda x: _jax_route(x, k, C), jnp.asarray(logits))
    got = tmoe.route(torch.from_numpy(logits), k, C)
    for name, g, w in zip(("gates", "eidx", "slot", "keep"), got, want):
        w = np.asarray(w)
        g = g.numpy()
        if name == "gates":     # a softmax over k: float32 rounding
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=name)
    # some pairs overflow their expert (C below the load) and some stay
    keep = got[3].numpy()
    assert keep.any() and (not keep.all() or C * E >= Tg * k)


def test_top_k_ties_go_to_the_lower_index_as_jax():
    logits = np.array([[[0.5, 1.0, 1.0, 0.2, 1.0, -1.0]],
                       [[2.0, 2.0, 2.0, 2.0, 2.0, 2.0]]], np.float32)
    for k in (1, 2, 3):
        want = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])
        got = tmoe.route(torch.from_numpy(logits), k, 8)[1].numpy()
        np.testing.assert_array_equal(got, want)


def _moe_pair(p, tp, x, **kw):
    want = _jit(lambda pp, xx: jmoe.moe_fwd(pp, xx, ctx=CTX, **kw), p,
                jnp.asarray(x))
    got = tmoe.moe_fwd(tp, torch.from_numpy(x), **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(capacity_factor=1.25),
    dict(capacity_factor=0.5),
    dict(capacity_factor=8.0, n_groups=4),
    dict(capacity_factor=1.0, n_groups=2)])
def test_moe_fwd_and_grads_match_jax(kw):
    p, tp = _params()
    x = _x((2, 16, 32), seed=1)
    # y and the gradients of sum(y * cot) with respect to x and each weight
    cot = _x((2, 16, 32), seed=2)

    def jloss(pp, xx):
        y = jmoe.moe_fwd(pp, xx, n_experts=8, top_k=2, ctx=CTX, **kw)
        return jnp.sum(y * cot), y

    (_, want), (jgp, jgx) = _jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), p, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y = tmoe.moe_fwd(leaves, tx, n_experts=8, top_k=2, **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=RTOL, err_msg="x")
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgp[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("G", [2, 4, 8])
def test_grouped_equals_global_when_dropless(G):
    p, tp = _params(seed=3)
    x = torch.from_numpy(_x((4, 16, 32), seed=G))
    y1 = tmoe.moe_fwd(tp, x, n_experts=8, top_k=2, capacity_factor=8.0,
                      n_groups=1)
    yG = tmoe.moe_fwd(tp, x, n_experts=8, top_k=2, capacity_factor=8.0,
                      n_groups=G)
    np.testing.assert_allclose(y1.numpy(), yG.numpy(), atol=1e-5)


def test_capacity_drops_give_zero_rows_as_jax():
    p, tp = _params(E=2)
    x = _x((1, 64, 32), seed=4)
    got, want = _moe_pair(p, tp, x, n_experts=2, top_k=1,
                          capacity_factor=0.25)
    zero = np.linalg.norm(got[0].numpy(), axis=-1) == 0
    assert zero.sum() > 0
    np.testing.assert_array_equal(
        zero, np.linalg.norm(np.asarray(want[0]), axis=-1) == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_aux_loss_matches_jax():
    logits = _x((512, 8), seed=5) * 0.5
    _, eidx = jax.lax.top_k(jnp.asarray(logits), 2)
    want = jmoe.moe_aux_loss(jnp.asarray(logits), eidx, 8)
    got = tmoe.moe_aux_loss(torch.from_numpy(logits),
                            torch.from_numpy(np.asarray(eidx).astype(
                                np.int64)), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
