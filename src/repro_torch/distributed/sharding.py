"""Where the score store's row blocks live (counterpart of
``repro/distributed/sharding.py:41-43, 117-130``).

The reference splits the store over its mesh's data-parallel axes; the
port's layout is a plain list of devices, one row block each
(``core.scores.ScoreSharding``). ``local_devices`` is the one place that
says which devices a run has: the trainer's ``--shard-scores`` and
``fault_tolerance.elastic_restart`` take their list from it, and a caller
that wants several blocks on fewer devices (the CPU tests, the card's
smoke run) replaces it. The reference's model-sharding rules
(``make_rules``, ``make_ctx``, ``axes_to_sharding``) serve only its XLA
dry-run tooling and have no counterpart.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def local_devices(device) -> List[torch.device]:
    """The devices of this process for a run on ``device``: every CUDA
    device for a CUDA run, the one CPU for a CPU run."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def score_store_sharding(devices: Sequence) -> Optional["ScoreSharding"]:
    """One row block per entry of ``devices`` (repeats allowed), or None
    when that gives fewer than two blocks (the store stays replicated)."""
    from ..core.scores import ScoreSharding
    if len(devices) < 2:
        return None
    return ScoreSharding(tuple(devices))
