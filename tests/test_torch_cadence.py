"""PyTorch port: the scoring cadence against the JAX package.

The four ``FreqSchedule`` kinds fire on the same steps as JAX's (exact),
``adaptive_period`` picks the same period over a grid, ``make_schedule``
opens the cap at k = 1, and six drift-cadence ``scheduled_step``s on
qwen1.5 smoke at float32 follow JAX's jitted ones: the period and
``last_scored`` sequences exactly, the EMAs, parameters and ``s``/``w``
to 1e-5 atol / 1e-4 rtol, ``seen`` exactly (the step-parity set-up of
``_torch_parity.py``; JAX's Gumbel noise injected).
"""
import jax
import numpy as np
import pytest

from _torch_parity import fast_jit
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from _torch_parity import (assert_cadence_close, assert_state_close,
                           host_batches, jax_batch, jax_gumbel, make_pair,
                           torch_batch)
from repro.core import frequency as jf
from repro.core.theory import transfer_gain as jax_transfer_gain
from repro_torch.core import frequency as tf
from repro_torch.core.theory import transfer_gain

SCHEDULES = [
    dict(kind="fixed", k=1), dict(kind="fixed", k=3),
    dict(kind="warmup", k=8, warmup_steps=10, ramp_steps=10),
    dict(kind="warmup", k=4, warmup_steps=1, ramp_steps=16),
    dict(kind="warmup", k=16, warmup_steps=5, ramp_steps=3),
    dict(kind="warmup", k=8, warmup_steps=0, ramp_steps=0),
    dict(kind="warmup", k=5, warmup_steps=7, ramp_steps=33),
    dict(kind="adaptive", k=16, beta1=0.2, beta2=0.9, gain_floor=0.5),
    dict(kind="adaptive", k=64, beta1=0.1, beta2=0.99, gain_floor=0.3),
    dict(kind="drift", k=8),
]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_firing_table_matches_jax(kw):
    js, ts = jf.FreqSchedule(**kw), tf.FreqSchedule(**kw)
    steps = np.arange(200)
    want = np.asarray(jax.jit(js.should_score)(steps))
    got = np.asarray([ts.should_score(int(t)) for t in steps])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.fires(steps), want)
    assert ts.scoring_steps(200) == js.scoring_steps(200) == want.sum()
    periods = np.asarray(jax.jit(js.period_at)(steps))
    assert [ts.period_at(int(t)) for t in steps] == periods.tolist()
    assert ts.target_period == js.target_period
    assert ts.always_scores() == js.always_scores()


def test_adaptive_period_matches_jax_over_grid():
    omega = np.linspace(0.0, np.pi, 33)
    np.testing.assert_array_equal(transfer_gain(0.2, 0.9, omega),
                                  jax_transfer_gain(0.2, 0.9, omega))
    for b1 in (0.0, 0.2, 0.5, 0.85):
        for b2 in (0.5, 0.9, 0.99):
            for floor in (0.2, 0.5, 0.8):
                for cap in (1, 2, 8, 64):
                    assert tf.adaptive_period(b1, b2, floor, cap) == \
                        jf.adaptive_period(b1, b2, floor, cap), \
                        (b1, b2, floor, cap)


@pytest.mark.parametrize("kind", ["adaptive", "drift"])
def test_make_schedule_opens_cap_at_k1(kind):
    t = tf.make_schedule(kind, 1, steps_per_epoch=8)
    j = jf.make_schedule(kind, 1, steps_per_epoch=8)
    assert t.k == j.k == tf.ADAPTIVE_DEFAULT_CAP
    assert t.target_period == j.target_period
    w = tf.make_schedule("warmup", 4, steps_per_epoch=8)
    assert (w.warmup_steps, w.ramp_steps) == (4, 8)


def test_drift_scheduled_steps_match_jax():
    cadence = dict(kind="drift", k_cap=8)
    jeng, jstate, teng, tstate, rng = make_pair(cadence=cadence)
    jstep = fast_jit(jeng.scheduled_step)
    periods, lasts, scored = [], [], []
    for host in host_batches(rng, 6):
        gumbel = jax_gumbel(jstate)
        jstate, jm = jstep(jstate, jax_batch(host))
        tstate, tm = teng.scheduled_step(tstate, torch_batch(host),
                                         gumbel=gumbel)
        assert tm["scored"] == float(jm["scored"])
        assert tm["cad_period"] == float(jm["cad_period"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-4)
        assert_cadence_close(tstate.cadence, jstate.cadence)
        assert tstate.cadence.servo is None
        periods.append(tstate.cadence.period)
        lasts.append(tstate.cadence.last_scored)
        scored.append(tm["scored"])
    assert_state_close(tstate, jstate)
    # the servo really moved the period and decimated the scoring
    assert len(set(periods)) > 1 and 0.0 in scored, (periods, scored)
    assert lasts[0] == 0 and lasts == sorted(lasts)
