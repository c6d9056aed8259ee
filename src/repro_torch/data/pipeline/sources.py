"""Batch sources of the data pipeline (counterpart of
``repro/data/pipeline/sources.py:46-74``).

A source has ``__len__`` and ``batch(ids) -> dict`` with at least
``tokens (B, S) i32``, ``labels (B, S) i32`` (-1 = masked) and
``sample_ids (B,) i32``; sample identity is positional and stable. The
port has the synthetic adapter here and ``PackedSource``
(``data/packed.py``); the file sources are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple

import numpy as np

from ..synthetic import SyntheticConfig, SyntheticLM


class Source(Protocol):
    def __len__(self) -> int: ...

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]: ...


class SyntheticSource:
    """Adapter over ``SyntheticLM``; the dataset stays reachable as
    ``.ds``."""

    def __init__(self, ds: Optional[SyntheticLM] = None, **cfg_kw):
        self.ds = ds or SyntheticLM(SyntheticConfig(**cfg_kw))

    def __len__(self) -> int:
        return len(self.ds)

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        return self.ds.batch(ids)


def source_fingerprint(source: Source) -> Tuple[str, int]:
    """(class name, length): recorded in the checkpoint manifest, so that
    a resume against another corpus fails instead of misaligning score
    rows."""
    return type(source).__name__, len(source)
