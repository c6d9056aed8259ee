"""Annealing schedule: plain uniform training at the first/last epochs
(a copy of ``repro/core/annealing.py``).

Paper (§3.1, Alg. 1): data selection is active only for
``E_a_start <= e < E - E_a_end``; outside that window the step degrades to
the standard batched baseline. Default annealing ratio 5% on each side.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AnnealSchedule:
    total_epochs: int
    start_epochs: int
    end_epochs: int

    @classmethod
    def from_ratio(cls, total_epochs: int, ratio: float = 0.05,
                   symmetric: bool = True) -> "AnnealSchedule":
        k = int(round(ratio * total_epochs))
        return cls(total_epochs=total_epochs, start_epochs=k,
                   end_epochs=k if symmetric else 0)

    def selection_active(self, epoch: int) -> bool:
        return (self.start_epochs <= epoch
                < self.total_epochs - self.end_epochs)
