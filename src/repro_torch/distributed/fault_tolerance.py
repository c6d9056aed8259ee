"""Preemption and straggler handling of the trainer (counterpart of
``repro/distributed/fault_tolerance.py:29-91``; framework-free, one
process).

  PreemptionHandler : SIGTERM/SIGINT -> checkpoint-and-exit at the next
                      step boundary (never mid-optimizer-update): the
                      handler only sets a flag that ``Trainer._record``
                      reads after each step.
  StragglerMonitor  : per-step wall-time EMA; flags steps slower than
                      ``threshold`` x the running mean once past
                      ``warmup_steps``, and keeps flagged steps out of
                      the mean.

The reference's ``elastic_restart`` (a new mesh for the surviving device
count, the checkpoint restored onto it) needs several processes and
belongs to the multi-GPU slice; it has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import List, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        """Take over ``signals`` (from the main thread, as
        ``signal.signal`` requires); ``uninstall`` gives them back."""
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preemption_requested(self) -> bool:
        return self._requested


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    mean: float
    ratio: float


class StragglerMonitor:
    """EMA step-time tracker; flags outlier steps."""

    def __init__(self, threshold: float = 2.0, ema: float = 0.9,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.ema = ema
        self.warmup = warmup_steps
        self._mean: Optional[float] = None
        self._count = 0
        self.reports: List[StragglerReport] = []

    def record(self, step: int, duration: float
               ) -> Optional[StragglerReport]:
        self._count += 1
        if self._mean is None:
            self._mean = duration
            return None
        if self._count > self.warmup \
                and duration > self.threshold * self._mean:
            flagged = StragglerReport(step=step, duration=duration,
                                      mean=self._mean,
                                      ratio=duration / self._mean)
            self.reports.append(flagged)
            # an outlier stays out of the mean, which keeps detection sharp
            return flagged
        self._mean = self.ema * self._mean + (1 - self.ema) * duration
        return None

    @property
    def mean_step_time(self) -> Optional[float]:
        return self._mean
