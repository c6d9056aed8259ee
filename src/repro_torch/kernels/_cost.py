"""What each kernel launch costs, reported to the dry run's counter.

A wrapper calls ``report`` where it launches its kernel on a CUDA tensor,
and where a ``meta`` tensor stands in for the launch: the dry run traces
the card's route on ``meta`` (``launch/cost.py``), and the wrapper then
returns empty outputs of the kernel's shapes and dtypes, launches nothing
and counts no launch. The counter cannot see inside a launch, so each
kernel states its own work: the FLOPs of its products and the bytes of
its formula's inputs read once and outputs written once. Each call sits
under ``if SINKS:``, so with no counter listening a launch pays one list
test and works out none of ``report``'s arguments.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

SINKS: List = []   # counters listening (launch/cost.py:CostCounter)
QUIET = [0]        # > 0 while a collective moves its data (unseen work)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def report(name: str, flops: float, dtype: torch.dtype,
           n_bytes: int) -> None:
    """One launch of kernel ``name``: ``flops`` of products in ``dtype``
    (0 for a kernel without products) and ``n_bytes`` of memory traffic."""
    for sink in SINKS:
        sink.kernel(name, flops, dtype, n_bytes)


@contextlib.contextmanager
def quiet():
    """Hide the ops inside from the counters: a collective's transport
    (``distributed/collectives.py``), which reports itself."""
    QUIET[0] += 1
    try:
        yield
    finally:
        QUIET[0] -= 1
