"""Thm. 3.2 frequency response of the Eq. (3.1) filter (a numpy copy of
``repro/core/theory.py:transfer_gain``), which sizes the ``adaptive``
scoring period (``core/frequency.py:adaptive_period``)."""
from __future__ import annotations

import numpy as np


def transfer_gain(beta1: float, beta2: float, omega: np.ndarray) -> np.ndarray:
    """|H(i w)| with H(w) = ((b2-b1) w + (1-b2)) / (w + (1-b2))  (Thm. 3.2)."""
    num = (beta2 - beta1) ** 2 * omega ** 2 + (1.0 - beta2) ** 2
    den = omega ** 2 + (1.0 - beta2) ** 2
    return np.sqrt(num / den)
