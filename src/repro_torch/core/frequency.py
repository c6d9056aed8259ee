"""Scoring-frequency schedules, paper §3.3 (counterpart of
``repro/core/frequency.py``).

The Eq. (3.1) weights are a low-pass filter of the loss signal, so the
scoring forward can be decimated to every k-th step with the stale
weights reused in between. Four kinds:

  fixed    : score every k-th step (k = 1 is serial ES).
  warmup   : score every step for ``warmup_steps``, then ramp the period
             from 1 to k over ``ramp_steps`` (a greedy firing table, then
             the k-grid anchored at its last firing).
  adaptive : the largest period <= k whose Nyquist rate keeps a
             ``gain_floor`` share of the Thm. 3.2 passband
             (``adaptive_period``).
  drift    : the engine's drift servo sets the period at run time
             (``core/engine.py:CadenceState``); k is its cap, and the
             static members answer conservatively (``period_at`` == cap,
             ``should_score`` == True).

The reference's step functions are jnp so that they trace into its
jitted step; here they are host functions of the (int) optimizer step,
and the decision to launch the scoring kernels is taken on the host
without reading the device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .theory import transfer_gain

KINDS = ("fixed", "warmup", "adaptive", "drift")


@functools.lru_cache(maxsize=None)
def adaptive_period(beta1: float, beta2: float, gain_floor: float,
                    k_cap: int, grid: int = 2048) -> int:
    """Largest period p <= k_cap retaining >= gain_floor of the passband.

    Scoring every p steps resolves loss-signal frequencies up to pi / p;
    r(p) = int_0^{pi/p} |H| / int_0^pi |H| (|H| from Thm. 3.2) is
    non-increasing in p, so a scan finds the last p with r(p) >= floor.
    """
    if k_cap <= 1:
        return 1
    omega = np.linspace(0.0, np.pi, grid)
    gain = transfer_gain(beta1, beta2, omega)
    cum = np.concatenate([[0.0], np.cumsum((gain[1:] + gain[:-1]) * 0.5
                                           * np.diff(omega))])
    total = cum[-1]
    if total <= 0.0:
        return k_cap
    best = 1
    for p in range(2, k_cap + 1):
        cut = np.interp(np.pi / p, omega, cum)
        if cut / total >= gain_floor:
            best = p
        else:
            break
    return best


@dataclasses.dataclass(frozen=True)
class FreqSchedule:
    """Scoring period as a function of the (0-indexed) optimizer step."""
    kind: str = "fixed"        # fixed | warmup | adaptive | drift
    k: int = 1                 # target / maximum scoring period
    warmup_steps: int = 0      # warmup: score every step this long
    ramp_steps: int = 0        # warmup: linear 1 -> k ramp length
    beta1: float = 0.2         # adaptive: ES filter coefficients
    beta2: float = 0.9
    gain_floor: float = 0.5    # adaptive: retained passband fraction

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown freq schedule kind {self.kind!r}")
        if self.k < 1:
            raise ValueError(f"scoring period k must be >= 1, got {self.k}")

    @functools.cached_property
    def target_period(self) -> int:
        if self.kind == "adaptive":
            return adaptive_period(self.beta1, self.beta2, self.gain_floor,
                                   self.k)
        return self.k

    def always_scores(self) -> bool:
        """True iff every step scores (the warmup ramp tops out at the
        target period, so a target of 1 means period 1 everywhere)."""
        return self.target_period == 1

    def period_at(self, step: int) -> int:
        """Scoring period at ``step``; the warmup ramp is computed in
        float32 as the reference's jnp form is."""
        k = self.target_period
        if self.kind != "warmup":
            return k
        f32 = np.float32
        ramp = max(self.ramp_steps, 1)
        frac = np.clip(f32(step - self.warmup_steps) / f32(ramp), f32(0.0),
                       f32(1.0))
        return max(int(np.round(f32(1.0) + frac * f32(k - 1))), 1)

    @functools.cached_property
    def _warmup_plan(self):
        """Greedy firing table for the warmup + ramp window: fire step t
        iff t - last_fired >= period(t); after it the k-grid is anchored at
        the table's last firing, so no gap exceeds the target period."""
        horizon = self.warmup_steps + self.ramp_steps
        k = self.target_period
        ramp = max(self.ramp_steps, 1)
        t = np.arange(max(horizon, 1))
        frac = np.clip((t - self.warmup_steps) / ramp, 0.0, 1.0)
        periods = np.maximum(np.round(1.0 + frac * (k - 1)), 1).astype(int)
        fires = np.zeros(max(horizon, 1), bool)
        last = -10 ** 9
        for i in range(horizon):
            if i - last >= periods[i]:
                fires[i] = True
                last = i
        anchor = last if horizon else 0
        return fires, int(anchor), horizon

    def fires(self, steps: np.ndarray) -> np.ndarray:
        """Bool array: which of ``steps`` run the scoring forward."""
        steps = np.asarray(steps, np.int64)
        if self.kind == "drift":
            return np.ones(steps.shape, bool)
        k = self.target_period
        if self.kind != "warmup" or k == 1:
            return steps % k == 0
        table, anchor, horizon = self._warmup_plan
        in_table = table[np.clip(steps, 0, max(horizon - 1, 0))]
        return np.where(steps < horizon, in_table, (steps - anchor) % k == 0)

    def should_score(self, step: int) -> bool:
        """Does ``step`` run the scoring forward? Step 0 always does."""
        return bool(self.fires(np.asarray(step)))

    def scoring_steps(self, total_steps: int) -> int:
        """How many of steps [0, total_steps) run the scoring forward."""
        return int(self.fires(np.arange(total_steps)).sum())


ADAPTIVE_DEFAULT_CAP = 64


def make_schedule(kind: str, k: int, *, steps_per_epoch: int = 0,
                  beta1: float = 0.2, beta2: float = 0.9,
                  gain_floor: float = 0.5) -> FreqSchedule:
    """Trainer-facing constructor with the reference's warmup/adaptive
    defaults; ``adaptive`` and ``drift`` at k = 1 open the cap to
    ``ADAPTIVE_DEFAULT_CAP`` (a cap of 1 would disable them)."""
    if kind == "warmup":
        return FreqSchedule(kind="warmup", k=k,
                            warmup_steps=max(steps_per_epoch // 2, 1),
                            ramp_steps=max(steps_per_epoch, 1),
                            beta1=beta1, beta2=beta2)
    if kind in ("adaptive", "drift") and k <= 1:
        k = ADAPTIVE_DEFAULT_CAP
    return FreqSchedule(kind=kind, k=k, beta1=beta1, beta2=beta2,
                        gain_floor=gain_floor)
