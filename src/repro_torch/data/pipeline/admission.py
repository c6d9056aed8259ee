"""Bounded-latency admission batching for the online scoring service (a
numpy copy of ``repro/data/pipeline/admission.py``).

Submitted rows wait in a queue and are scored in batches. A drain fires
as soon as ``max_batch`` rows are pending (the throughput bound) or the
oldest has waited ``max_delay_s`` (the latency bound). Draining is pulled:
the service calls ``poll()`` between trained steps and ``flush()`` at the
end, so admission interleaves with training deterministically, with no
thread, and a test can drive it with a fake clock.

A drain scores its rows with the caller's ``score_fn`` (per-sample losses
on the live weights) and admits those that ``filter_fn`` passes, the
Eq. (3.1) rule of ``es_admission_filter``: a candidate is worth training
on when the weight ES would give it clears a threshold set by the store's
weights.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


def es_admission_filter(losses: np.ndarray, *, s_ref: float, w_ref: float,
                        beta1: float, tau: float) -> np.ndarray:
    """Eq. (3.1) for candidates without a score row: the would-be weight
    ``beta1 * s_ref + (1 - beta1) * loss``, with the store's mean s as the
    prior, must reach ``tau * w_ref`` (``w_ref`` the store's mean weight).
    ``tau = 0`` admits everything."""
    w_cand = beta1 * float(s_ref) + (1.0 - beta1) * np.asarray(
        losses, np.float32)
    return w_cand >= tau * float(w_ref)


@dataclasses.dataclass
class AdmissionResult:
    """One drained batch: what was scored and what got in."""
    tokens: np.ndarray       # (M, S) i32
    labels: np.ndarray       # (M, S) i32
    losses: np.ndarray       # (M,) f32, per-sample loss on the live weights
    admitted: np.ndarray     # (M,) bool
    latencies_s: np.ndarray  # (M,) f32, submit -> drain


class AdmissionController:
    def __init__(self, score_fn: Callable[[np.ndarray, np.ndarray],
                                          np.ndarray],
                 filter_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 16, max_delay_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.score_fn = score_fn
        self.filter_fn = filter_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._clock = clock
        self._pending: Deque[Tuple[np.ndarray, np.ndarray, float]] = deque()
        self._latencies: List[float] = []
        self.submitted = 0
        self.admitted = 0

    def submit(self, tokens: np.ndarray, labels: np.ndarray) -> None:
        """Queue candidate rows, (S,) or (M, S), for the next drain."""
        tokens = np.atleast_2d(np.asarray(tokens, np.int32))
        labels = np.atleast_2d(np.asarray(labels, np.int32))
        if tokens.shape != labels.shape:
            raise ValueError(f"submit: token/label shape mismatch "
                             f"{tokens.shape} / {labels.shape}")
        now = self._clock()
        for t, l in zip(tokens, labels):
            self._pending.append((t, l, now))
        self.submitted += len(tokens)

    def __len__(self) -> int:
        return len(self._pending)

    def due(self) -> bool:
        """True when the batch is full or the oldest row has waited the
        latency bound."""
        if len(self._pending) >= self.max_batch:
            return True
        if not self._pending:
            return False
        return self._clock() - self._pending[0][2] >= self.max_delay_s

    def poll(self) -> Optional[AdmissionResult]:
        """Drain one batch if one is due, else None."""
        if not self.due():
            return None
        return self._drain()

    def flush(self) -> Optional[AdmissionResult]:
        """Drain what is pending, bounds or not."""
        if not self._pending:
            return None
        return self._drain()

    def _drain(self) -> AdmissionResult:
        take = min(len(self._pending), self.max_batch)
        rows = [self._pending.popleft() for _ in range(take)]
        now = self._clock()
        tokens = np.stack([r[0] for r in rows])
        labels = np.stack([r[1] for r in rows])
        lat = np.asarray([now - r[2] for r in rows], np.float32)
        losses = np.asarray(self.score_fn(tokens, labels),
                            np.float32).reshape(-1)
        if losses.shape[0] != take:
            raise ValueError(f"score_fn returned {losses.shape[0]} losses "
                             f"for {take} rows")
        admitted = np.asarray(self.filter_fn(losses), bool).reshape(-1)
        self._latencies.extend(float(x) for x in lat)
        self.admitted += int(admitted.sum())
        return AdmissionResult(tokens=tokens, labels=labels, losses=losses,
                               admitted=admitted, latencies_s=lat)

    def latency_stats(self) -> Dict[str, float]:
        lat = np.asarray(self._latencies, np.float64)
        if not len(lat):
            return {"admit_latency_mean_s": 0.0,
                    "admit_latency_p50_s": 0.0,
                    "admit_latency_p95_s": 0.0}
        return {"admit_latency_mean_s": float(lat.mean()),
                "admit_latency_p50_s": float(np.percentile(lat, 50)),
                "admit_latency_p95_s": float(np.percentile(lat, 95))}
