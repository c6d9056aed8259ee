"""PyTorch port: pipelined ES and its epoch driver against the JAX package.

One ``prime_step``, three ``pipelined_step``s and one ``flush_step`` on
qwen1.5 smoke at float32 follow JAX's jitted steps (the set-up of
``_torch_parity.py``; JAX's Gumbel noise injected): ``pending_w``, the
store, the parameters, the cadence and the metrics to 1e-5 atol / 1e-4
rtol, the selected index sets and ``seen`` exactly. On the CPU the two
legs run one after the other; the CUDA streams are held to the same
order on the card by ``chip_smoke.py``. The session and cadence cases
mirror ``tests/test_engine.py``'s.
"""
import jax
import numpy as np
import torch

from _torch_parity import fast_jit
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from _torch_parity import (ATOL, RTOL, B, assert_state_close, host_batches,
                           jax_batch, jax_gumbel, make_pair, torch_batch)
from repro.core.selection import gumbel_topk_select


def _want_selected(jstate):
    key = jax.random.split(jstate.rng)[1]
    return set(np.asarray(gumbel_topk_select(key, jstate.pending_w,
                                             4)).tolist())


def _assert_pending_close(tstate, jstate):
    np.testing.assert_allclose(tstate.pending_w.numpy(),
                               np.asarray(jstate.pending_w), atol=ATOL,
                               rtol=RTOL)


def test_prime_pipelined_flush_match_jax():
    jeng, jstate, teng, tstate, rng = make_pair()
    hosts = host_batches(rng, 4)
    jstate = fast_jit(jeng.prime_step)(jstate, jax_batch(hosts[0]))
    tstate = teng.prime_step(tstate, torch_batch(hosts[0]))
    assert tstate.pending_w.shape == (B,)
    _assert_pending_close(tstate, jstate)
    assert_state_close(tstate, jstate)
    assert tstate.cadence.last_scored == -1
    jpipe = fast_jit(jeng.pipelined_step)
    for cur, nxt in zip(hosts[:-1], hosts[1:]):
        want_sel, gumbel = _want_selected(jstate), jax_gumbel(jstate)
        jstate, jm = jpipe(jstate, (jax_batch(cur), jax_batch(nxt)))
        tstate, tm = teng.pipelined_step(
            tstate, (torch_batch(cur), torch_batch(nxt)), gumbel=gumbel)
        assert set(tm["selected"].tolist()) == want_sel
        for k in ("loss", "sel_loss", "bp_samples", "scored", "cad_period"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
        _assert_pending_close(tstate, jstate)
        assert_state_close(tstate, jstate)
    want_sel, gumbel = _want_selected(jstate), jax_gumbel(jstate)
    jstate, jm = fast_jit(jeng.flush_step)(jstate, jax_batch(hosts[-1]))
    tstate, tm = teng.flush_step(tstate, torch_batch(hosts[-1]),
                                 gumbel=gumbel)
    assert set(tm["selected"].tolist()) == want_sel
    assert tm["scored"] == float(jm["scored"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=ATOL, rtol=RTOL)
    assert_state_close(tstate, jstate)


def _port_only(**kw):
    _, _, teng, tstate, rng = make_pair(**kw)
    return teng, tstate, [torch_batch(h) for h in host_batches(rng, 4)]


def test_session_primes_holds_and_flushes():
    teng, tstate, batches = _port_only()
    sess = teng.session(selection_on=True, pipelined=True)
    trained = 0
    for i, batch in enumerate(batches):
        tstate, m = sess.step(tstate, batch)
        assert sess.has_held
        assert (m is None) == (i == 0)      # the first batch is primed
        trained += m is not None
    assert sess.scoring_primes == 1
    tstate, m = sess.finish(tstate)
    assert m is not None and m["scored"] == 0.0 and not sess.has_held
    trained += 1
    assert trained == 4 and tstate.opt.step == 4   # none dropped
    seen = int(tstate.scores.seen.sum())    # the store updates in place
    assert sess.finish(tstate)[1] is None          # nothing left to drain
    # selection off: baseline steps, no prime, nothing held
    off = teng.session(selection_on=False, pipelined=True)
    tstate, m = off.step(tstate, batches[0])
    assert m is not None and not off.has_held and off.scoring_primes == 0
    assert int(tstate.scores.seen.sum()) == seen + B
    # run() steps every batch; the caller drains the carry
    sess = teng.session(selection_on=True, pipelined=True)
    got = []
    tstate = sess.run(tstate, batches, on_metrics=got.append)
    assert len(got) == 3 and sess.has_held and sess.scoring_primes == 1


def test_prime_does_not_suppress_first_pipelined_scoring():
    teng, tstate, batches = _port_only(cadence=dict(kind="drift", k_cap=1))
    tstate = teng.prime_step(tstate, batches[0])
    tstate, m = teng.pipelined_step(tstate, (batches[0], batches[1]))
    assert m["scored"] == 1.0


def test_pipelined_decimation_skips_scoring_leg():
    teng, tstate, batches = _port_only(freq=dict(kind="fixed", k=2))
    scored = []
    for i in range(4):
        pair = (batches[i], batches[(i + 1) % 4])
        before = [t.clone() for t in (tstate.scores.s, tstate.scores.w,
                                      tstate.scores.seen)]
        tstate, m = teng.pipelined_step(tstate, pair)
        scored.append(m["scored"])
        if m["scored"] == 0.0:
            # skipped: the store is untouched and the carried weights are
            # the stale store's for the next batch
            for a, t in zip(before, (tstate.scores.s, tstate.scores.w,
                                     tstate.scores.seen)):
                torch.testing.assert_close(a, t, rtol=0, atol=0)
            ids = pair[1]["sample_ids"].long()
            torch.testing.assert_close(tstate.pending_w,
                                       tstate.scores.w[ids], rtol=0, atol=0)
            assert m["loss"] is m["sel_loss"]
    assert scored == [1.0, 0.0, 1.0, 0.0]
