"""Preemption and straggler handling of the trainer, and the elastic
restore (counterpart of ``repro/distributed/fault_tolerance.py:29-106``).

  PreemptionHandler : SIGTERM/SIGINT -> checkpoint-and-exit at the next
                      step boundary (never mid-optimizer-update): the
                      handler only sets a flag that ``Trainer._record``
                      reads after each step.
  StragglerMonitor  : per-step wall-time EMA; flags steps slower than
                      ``threshold`` x the running mean once past
                      ``warmup_steps``, and keeps flagged steps out of
                      the mean.
  elastic_restart   : the store's device list rebuilt for the devices
                      present, and the checkpoint restored onto it.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, List, Optional


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


def elastic_restart(checkpointer, make_template: Callable[[list], Any],
                    device="cuda", step: Optional[int] = None):
    """Restore onto the devices present now -> ``(devices, state)``.

    ``make_template(devices)`` builds a state (nested dicts of tensors)
    whose score leaves lie in one row block per device of
    ``sharding.local_devices(device)``; the checkpointer reshards the
    saved leaves onto it, whatever device count wrote them. The
    reference returns its new mesh; the port has none, and returns the
    device list in its place.
    """
    from . import sharding
    devices = sharding.local_devices(device)
    template = make_template(devices)
    state = checkpointer.restore(template, step=step)
    return devices, state
