"""Epoch sampler: the (seed, epoch) permutation, its meta-batches and the
resumable cursor (counterpart of ``repro/data/pipeline/sampler.py:106-248``).

The permutation ``np.random.default_rng((seed, epoch)).permutation(n)`` is
the reference's, so both packages walk the same sample ids in the same
order. The cursor (epoch, step and every field that shapes the batch ids)
rides the checkpoint manifest: a run that restores it and asks for
``epoch_batches(source, epoch, step)`` sees exactly the batch ids the
uninterrupted run would have seen, and one whose seed, meta-batch or
``drop_last`` differs raises instead of replaying other batches.

Not ported yet: kept-sets (set-level pruning) with their grad scales,
growth and multi-host slicing. The cursor carries their fields at the
values of a run without them (kept digest "full", no growth, one host),
so its manifest entry has the reference's keys.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

# the kept-set digest of a run that prunes nothing (the reference's
# ``kept_digest(None)``); the port's only one until pruning is ported
FULL = "full"


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

    def epoch_batches(self, source, epoch: int, start_step: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches of meta-batches ``start_step..`` of the epoch."""
        for _, ids in self.epoch_id_stream(epoch, start_step):
            yield source.batch(ids)

    # ---- resumable cursor ------------------------------------------------
    def cursor(self, epoch: int, step: int) -> Dict:
        """The manifest's position: ``step`` meta-batches of ``epoch``
        consumed, and every field that shapes the batch ids."""
        return {"epoch": int(epoch), "step": int(step),
                "seed": int(self.seed), "meta_batch": self.meta_batch,
                "num_hosts": 1, "drop_last": self.drop_last,
                "kept_digest": FULL, "growth": [],
                "kept_pop": self.n_samples}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The arrays of the checkpoint's ``extra/`` channel: none until
        kept-sets are ported (the reference's kept-set and grad scales)."""
        return {}

    def load_state(self, extras: Dict[str, np.ndarray],
                   cursor: Optional[Dict] = None) -> None:
        """Check a checkpoint's cursor against this run: a different seed,
        meta-batch, host count, ``drop_last`` or kept-set would replay
        other batch ids. ``extras`` holds no sampler arrays until
        kept-sets are ported."""
        if cursor is None:
            return
        mismatches = [
            f"{field} (manifest {cursor[field]!r} != run {have!r})"
            for field, have in (("seed", int(self.seed)),
                                ("meta_batch", self.meta_batch),
                                ("num_hosts", 1),
                                ("drop_last", self.drop_last),
                                ("kept_digest", FULL))
            if field in cursor and cursor[field] != have]
        if mismatches:
            raise ValueError(
                "sampler resume: cursor mismatch; restoring this checkpoint "
                "into the current run would reproduce different batch ids: "
                + "; ".join(mismatches))
