"""PyTorch port: the paper's analysis functions against the JAX package's
on seeded inputs: Eq. (3.1) read without mutation (``batch_weights``),
its unrolled form, Eq. (3.2), the Thm. 3.2 transfer function and the
selection probabilities in float32 (1e-6 relative), and the Prop. B.2
DRO helpers in float64 (1e-12 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import scores as jscores
from repro.core import selection as jselection
from repro.core import theory as jtheory
from repro_torch.core import scores as tscores
from repro_torch.core import selection as tselection
from repro_torch.core import theory as ttheory

F32 = dict(rtol=1e-6, atol=0)
F64 = dict(rtol=1e-12, atol=0)
BETAS = [(0.2, 0.9), (0.5, 0.5), (0.9, 0.3)]


def _losses(seed, n=20):
    return np.random.default_rng(seed).uniform(0.05, 5.0, n)


def test_batch_weights_matches_reference():
    rng = np.random.default_rng(0)
    s = rng.uniform(0.5, 6.0, 64).astype(np.float32)
    ids = rng.permutation(64)[:16].astype(np.int32)
    losses = rng.uniform(0.1, 4.0, 16).astype(np.float32)
    want = jscores.batch_weights(
        jscores.ESScores(s=jnp.asarray(s), w=jnp.zeros(64, jnp.float32),
                         seen=jnp.zeros(64, jnp.int32)),
        jnp.asarray(ids), jnp.asarray(losses), 0.2, 0.9)
    store = tscores.ESScores(s=torch.from_numpy(s), w=torch.zeros(64),
                             seen=torch.zeros(64, dtype=torch.int32))
    got = tscores.batch_weights(store, torch.from_numpy(ids),
                                torch.from_numpy(losses), 0.2, 0.9)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert torch.equal(store.s, torch.from_numpy(s))   # nothing mutated


@pytest.mark.parametrize("beta1,beta2", BETAS)
def test_unrolled_and_expansion_weights_match_reference(beta1, beta2):
    """Eq. (3.1) unrolled and Eq. (3.2) equal the reference's, and each
    other (the expansion is exact, its tail included)."""
    lh = _losses(1).astype(np.float32)
    s0 = 1.0 / 7
    t = torch.from_numpy(lh)
    exp_w = tscores.explicit_weights(t, beta1, beta2, s0)
    exp2_w = tscores.expansion_weights(t, beta1, beta2, s0)
    np.testing.assert_allclose(
        float(exp_w), float(jscores.explicit_weights(jnp.asarray(lh), beta1,
                                                     beta2, s0)), **F32)
    np.testing.assert_allclose(
        float(exp2_w), float(jscores.expansion_weights(jnp.asarray(lh),
                                                       beta1, beta2, s0)),
        **F32)
    np.testing.assert_allclose(float(exp2_w), float(exp_w), rtol=1e-5)


def test_transfer_function_and_selection_probs_match_reference():
    om = np.logspace(-3, 3, 200).astype(np.float32)
    for beta1, beta2 in BETAS:
        np.testing.assert_allclose(
            tscores.transfer_function(beta1, beta2,
                                      torch.from_numpy(om)).numpy(),
            np.asarray(jscores.transfer_function(beta1, beta2,
                                                 jnp.asarray(om))), **F32)
    w = np.random.default_rng(2).uniform(0.0, 3.0, 33).astype(np.float32)
    w[[3, 7]] = 0.0                       # clamped to the epsilon
    np.testing.assert_allclose(
        tselection.selection_probs(torch.from_numpy(w)).numpy(),
        np.asarray(jselection.selection_probs(jnp.asarray(w))), **F32)


@pytest.mark.parametrize("beta1,beta2", BETAS)
def test_dro_helpers_match_reference(beta1, beta2):
    """Prop. B.2 in float64: the reference loss, the DRO update and the
    Eq. (3.1) sequence equal the reference's; replaying the DRO update
    gives the ES weights."""
    lh = _losses(3)
    s0 = 1.0 / 7
    w_t, s_t = ttheory.es_weight_sequence(torch.from_numpy(lh), beta1,
                                          beta2, s0)
    w_j, s_j = jtheory.es_weight_sequence(lh, beta1, beta2, s0)
    assert w_t.dtype == torch.float64
    np.testing.assert_allclose(w_t.numpy(), w_j, **F64)
    np.testing.assert_allclose(s_t.numpy(), s_j, **F64)
    w = beta1 * s0 + (1 - beta1) * lh[0]
    for t in range(1, len(lh)):
        lref = ttheory.dro_reference_loss(lh[:t], beta1, beta2, s0)
        np.testing.assert_allclose(
            lref, jtheory.dro_reference_loss(lh[:t], beta1, beta2, s0), **F64)
        w_next = ttheory.dro_weight_update(w, lh[t], lref, beta1)
        assert w_next == jtheory.dro_weight_update(w, lh[t], lref, beta1)
        w = w_next
        np.testing.assert_allclose(w, w_t[t].item(), rtol=1e-9)
