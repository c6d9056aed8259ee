"""Scoring-frequency schedule (counterpart of ``repro/core/frequency.py``,
``FreqSchedule`` with ``kind="fixed"``).

``fixed`` scores every k-th step (k = 1 is serial ES). The other kinds of
the reference (warmup, adaptive, drift) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

KINDS = ("fixed", "warmup", "adaptive", "drift")


@dataclasses.dataclass(frozen=True)
class FreqSchedule:
    """Scoring period as a function of the (0-indexed) optimizer step."""
    kind: str = "fixed"
    k: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown freq schedule kind {self.kind!r}")
        if self.kind != "fixed":
            raise NotImplementedError(
                f"freq schedule {self.kind!r} is not ported yet; the "
                f"PyTorch port runs 'fixed'")
        if self.k < 1:
            raise ValueError(f"scoring period k must be >= 1, got {self.k}")

    def always_scores(self) -> bool:
        """True iff every step scores: scheduled_step is serial ES."""
        return self.k == 1

    def period_at(self, step: int) -> int:
        return self.k

    def should_score(self, step: int) -> bool:
        """Does ``step`` run the scoring forward? Step 0 always does."""
        return step % self.k == 0
