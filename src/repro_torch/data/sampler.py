"""Epoch sampler: the (seed, epoch) permutation and its meta-batches
(counterpart of ``repro/data/pipeline/sampler.py:106-137``).

The permutation ``np.random.default_rng((seed, epoch)).permutation(n)`` is
the reference's, so both packages walk the same sample ids in the same
order. Not ported yet: kept-sets (set-level pruning), growth, multi-host
slicing and the resumable cursor.
"""
from __future__ import annotations

import numpy as np


class ESSampler:
    def __init__(self, n_samples: int, meta_batch: int, *, seed: int = 0,
                 drop_last: bool = True):
        self.n_samples = int(n_samples)
        self.meta_batch = int(meta_batch)
        self.seed = seed
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(np.arange(self.n_samples))

    def steps_per_epoch(self, epoch: int = 0) -> int:
        n = self.n_samples
        return n // self.meta_batch if self.drop_last \
            else -(-n // self.meta_batch)

    def batch_ids(self, epoch: int, step: int) -> np.ndarray:
        """Sample ids of meta-batch ``step`` of ``epoch``."""
        idx = self.epoch_indices(epoch)
        ids = idx[step * self.meta_batch:(step + 1) * self.meta_batch]
        if len(ids) < self.meta_batch and self.drop_last:
            return ids[:0]
        return ids

    def epoch_id_stream(self, epoch: int, start_step: int = 0):
        """(step, ids) for meta-batches ``start_step..`` of the epoch; the
        permutation is drawn once per epoch."""
        idx = self.epoch_indices(epoch)
        for b in range(start_step, self.steps_per_epoch(epoch)):
            yield b, idx[b * self.meta_batch:(b + 1) * self.meta_batch]
