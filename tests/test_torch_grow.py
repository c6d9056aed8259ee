"""PyTorch port: growing the score stores against the JAX package.

* ``ReplicatedStore.grow`` and ``QuantizedStore.grow`` on warm states
  carried across with ``bridge.scores_from_jax`` equal JAX's grow: old
  rows (codes and scales for the int8 store) bitwise, the new rows at
  the 1/n' prior with ``seen`` 0, a new row in an old partial tail block
  on that block's grid, the ring unchanged; grown twice in a row;
* then a chain of updates that reaches old and new rows, against JAX's
  update on its grown store: the f32 store bitwise, the int8 store at
  ``tests/test_torch_quant_store.py``'s tolerances (integer leaves and
  scales bitwise, residuals within 1e-7), gathers included;
* ``n_new <= 0`` raises on both stores, and a block that would change
  across the grow (``block`` above the old row count) raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import scores as jscores
from repro_torch.bridge import scores_from_jax
from repro_torch.core import scores as tscores

B1, B2 = 0.2, 0.9
QFIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
           "err_seq", "err_s", "err_w")


def _equal(got, want, fields, resid_atol=None):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if resid_atol is not None and f in ("err_s", "err_w"):
            np.testing.assert_allclose(g, w, atol=resid_atol, rtol=0,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def _stores(kind, block=64, R=512):
    if kind == "f32":
        return jscores.make_store(None), tscores.make_store(None), \
            ("s", "w", "seen"), None
    return (jscores.make_store(None, quantize=True, block=block,
                               residual_rows=R),
            tscores.make_store(None, quantize=True, block=block,
                               residual_rows=R), QFIELDS, 1e-7)


def _warm(st, n, rng, steps=2, B=40):
    leaf = st.init_leaf(n)
    for _ in range(steps):
        ids = jnp.asarray(rng.choice(n, B, replace=False), jnp.int32)
        leaf = st.update(leaf, ids, jnp.asarray(
            rng.uniform(0.1, 3.0, B), jnp.float32), B1, B2)
    return leaf


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("n,grows", [(512, (64, 200)), (500, (13, 1))])
def test_grow_then_updates_match_jax(kind, n, grows):
    """512 grows by a whole block, then by a ragged 200; 500 leaves a
    partial tail block of 64 that the new rows fill, twice."""
    jst, tst, fields, atol = _stores(kind)
    rng = np.random.default_rng(n + len(grows))
    jleaf = _warm(jst, n, rng)
    tleaf = scores_from_jax(jax.device_get(jleaf))
    before = {f: getattr(tleaf, f).clone() for f in fields}
    n_tot = n
    for n_new in grows:
        jst, jleaf = jst.grow(jleaf, n_new)
        tst2, tleaf = tst.grow(tleaf, n_new)
        assert tst2 is tst
        _equal(tleaf, jleaf, fields)
        n_tot += n_new
        if kind == "f32":          # this grow's rows at the 1/n' prior
            prior = np.float32(1.0 / n_tot)
            assert (tleaf.s[n_tot - n_new:].numpy() == prior).all()
            assert (tleaf.w[n_tot - n_new:].numpy() == prior).all()
    # old rows (and the int8 store's old blocks' scales, its ring) as
    # they were; new rows at the prior, never seen
    for f in fields:
        old = before[f]
        if f in ("err_rows", "err_seq", "err_s", "err_w"):
            assert torch.equal(getattr(tleaf, f), old)
        else:
            assert torch.equal(getattr(tleaf, f)[:old.shape[0]], old)
    if kind == "f32":
        assert (tleaf.seen[n:] == 0).all()
    else:
        assert (tleaf.seen_q[n:] == 0).all()
        assert tleaf.s_q.shape[0] == n_tot
        assert tleaf.s_scale.shape[0] == -(-n_tot // 64)
    # a chain of updates over old and new rows (the ring roomy enough
    # that no live residual is recycled inside a batch, as in
    # tests/test_torch_quant_store.py: JAX's scatter form reads the
    # pre-batch ring)
    for step in range(3):
        # distinct ids, four of them among the last rows (new ones)
        ids = np.concatenate([
            rng.choice(n_tot - 12, 36, replace=False),
            n_tot - 1 - rng.choice(12, 4, replace=False)]).astype(np.int32)
        losses = rng.uniform(0.05, 4.0 * (step + 1),
                             len(ids)).astype(np.float32)
        # eager JAX: under jit, XLA rounds Eq. (3.1) differently (1 ulp of
        # s); the port rounds as JAX eager does
        jleaf = jst.update(jleaf, jnp.asarray(ids), jnp.asarray(losses),
                           B1, B2)
        tleaf = tst.update(tleaf, torch.from_numpy(ids),
                           torch.from_numpy(losses), B1, B2)
        _equal(tleaf, jleaf, fields, atol)
        got = tst.gather(tleaf, torch.from_numpy(ids))
        want = jst.gather(jleaf, jnp.asarray(ids))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=1e-7 if atol else 0, rtol=0)


def test_grow_refuses_bad_sizes():
    for st in (tscores.make_store(None),
               tscores.make_store(None, quantize=True, block=16)):
        leaf = st.init_leaf(64, "cpu")
        for n_new in (0, -3):
            with pytest.raises(ValueError, match="n_new"):
                st.grow(leaf, n_new)
    # block 128 over 100 rows is clamped to 100; after a grow it would be
    # 128 and every old row would re-code
    st = tscores.make_store(None, quantize=True, block=128)
    leaf = st.init_leaf(100, "cpu")
    with pytest.raises(ValueError, match="block"):
        st.grow(leaf, 40)
    jst = jscores.make_store(None, quantize=True, block=128)
    with pytest.raises(ValueError, match="block"):
        jst.grow(jst.init_leaf(100), 40)
    # a grow that keeps the clamped block (still <= the old count) is fine
    st.grow(tscores.make_store(None, quantize=True, block=128).init_leaf(
        128, "cpu"), 40)
