"""The paper's theory appendix on tensors (counterpart of
``repro/core/theory.py``): the Thm. 3.2 frequency response of the
Eq. (3.1) filter, which sizes the ``adaptive`` scoring period
(``core/frequency.py:adaptive_period``; numpy, as the reference), and the
Prop. B.2 DRO view of Eq. (3.1) in float64, for the theory checks.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def transfer_gain(beta1: float, beta2: float, omega):
    """|H(i w)| with H(w) = ((b2-b1) w + (1-b2)) / (w + (1-b2))  (Thm. 3.2),
    on a numpy array (the cadence's scan) or a tensor
    (``scores.transfer_function``), of the same kind back."""
    num = (beta2 - beta1) ** 2 * omega ** 2 + (1.0 - beta2) ** 2
    den = omega ** 2 + (1.0 - beta2) ** 2
    sqrt = torch.sqrt if isinstance(omega, torch.Tensor) else np.sqrt
    return sqrt(num / den)


def dro_reference_loss(loss_history, beta1: float, beta2: float,
                       s0: float) -> float:
    """Prop. B.2 reference loss l_ref(theta(1:t)) for one sample.

    l_ref = (1-2b1+b1 b2)/(1-b1) * l(t)
          + b1(1-b2)^2/(1-b1) * sum_{k=1..t-1} b2^{t-1-k} l(k)
          + b1(1-b2) b2^{t-1} / (1-b1) * s0
    """
    lh = torch.as_tensor(loss_history, dtype=torch.float64)
    t = lh.shape[0]
    c1 = (1 - 2 * beta1 + beta1 * beta2) / (1 - beta1)
    hist = sum(beta2 ** (t - 1 - k) * lh[k - 1] for k in range(1, t))
    c2 = beta1 * (1 - beta2) ** 2 / (1 - beta1)
    c3 = beta1 * (1 - beta2) * beta2 ** (t - 1) / (1 - beta1)
    return float(c1 * lh[t - 1] + c2 * hist + c3 * s0)


def dro_weight_update(w_prev: float, loss_new: float, l_ref: float,
                      beta1: float) -> float:
    """Eq. (B.30)/(B.35): w(t+1) = w(t) + (1-beta1) (l(t+1) - l_ref)."""
    return w_prev + (1.0 - beta1) * (loss_new - l_ref)


def es_weight_sequence(loss_history, beta1: float, beta2: float, s0: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Eq. (3.1) over a loss history; returns (w_seq, s_seq), float64."""
    lh = torch.as_tensor(loss_history, dtype=torch.float64)
    T = lh.shape[0]
    w = torch.empty(T, dtype=torch.float64)
    s_seq = torch.empty(T, dtype=torch.float64)
    s = s0
    for t in range(T):
        w[t] = beta1 * s + (1 - beta1) * lh[t]
        s = beta2 * s + (1 - beta2) * lh[t]
        s_seq[t] = s
    return w, s_seq
