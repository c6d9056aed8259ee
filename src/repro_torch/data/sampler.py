"""Epoch sampler: the (seed, epoch) permutation over the kept-set, its
meta-batches with their InfoBatch rescale, and the resumable cursor
(counterpart of ``repro/data/pipeline/sampler.py:29-35`` and
``:88-248``).

The permutation ``np.random.default_rng((seed, epoch)).permutation(pool)``
is the reference's, so both packages walk the same sample ids in the same
order. ``pool`` is every id, or the kept-set that set-level pruning
installed (``apply_pruning``). Ids are global dataset positions, never
re-indexed by pruning, so the (n,) score store needs no remapping when
the kept-set changes.

The cursor (epoch, step, kept-set digest and every field that shapes the
batch ids) rides the checkpoint manifest, and the kept-set and grad
scales ride its extras (``state_arrays``): a run that restores them and
asks for ``epoch_batches(source, epoch, step)`` sees exactly the batch
ids and scales the uninterrupted run would have seen, and one whose seed,
meta-batch, ``drop_last`` or kept-set differs raises instead of
replaying other batches.

Not ported yet: growth and multi-host slicing. The cursor carries their
fields at the values of a run without them (no growth, the kept
population the whole dataset, one host), so its manifest entry has the
reference's keys.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Optional

import numpy as np


def kept_digest(kept: Optional[np.ndarray]) -> str:
    """Stable digest of a kept-set (``"full"`` when nothing is pruned),
    recorded in the checkpoint manifest and checked on resume."""
    if kept is None:
        return "full"
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(kept, np.int64))).hexdigest()[:16]


class ESSampler:
    def __init__(self, n_samples: int, meta_batch: int, *, seed: int = 0,
                 drop_last: bool = True):
        self.n_samples = int(n_samples)
        self.meta_batch = int(meta_batch)
        self.seed = seed
        self.drop_last = drop_last
        self._kept: Optional[np.ndarray] = None
        self._grad_scale: Optional[np.ndarray] = None

    # ---- set-level pruning's epoch hook ----------------------------------
    def apply_pruning(self, kept: Optional[np.ndarray],
                      grad_scale: Optional[np.ndarray] = None) -> None:
        """Install the kept ids (None: every id) and the optional (n,)
        per-sample grad scale for the epochs that follow."""
        self._kept = None if kept is None else np.asarray(kept)
        self._grad_scale = None if grad_scale is None \
            else np.asarray(grad_scale, np.float32)

    @property
    def kept(self) -> Optional[np.ndarray]:
        return self._kept

    @property
    def grad_scale(self) -> Optional[np.ndarray]:
        return self._grad_scale

    # ---- permutation / shape ---------------------------------------------
    def _epoch_pool(self, epoch: int) -> np.ndarray:
        """The ids the epoch walks: the installed kept-set, or every id."""
        if self._kept is None:
            return np.arange(self.n_samples)
        return self._kept[self._kept < self.n_samples]

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self._epoch_pool(epoch))

    def steps_per_epoch(self, epoch: int = 0) -> int:
        """Meta-batches in ``epoch``, counted over its pool."""
        n = len(self._epoch_pool(epoch))
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
        """Host batches of meta-batches ``start_step..`` of the epoch, with
        the installed grad scale as ``grad_scale``."""
        for _, ids in self.epoch_id_stream(epoch, start_step):
            batch = source.batch(ids)
            if self._grad_scale is not None:
                batch["grad_scale"] = self.grad_scale_for(ids)
            yield batch

    def grad_scale_for(self, ids: np.ndarray) -> np.ndarray:
        """The grad scale of a batch's ids; an id beyond the scale's rows
        takes the neutral 1.0."""
        gs = self._grad_scale
        if gs is None:
            return np.ones(len(ids), np.float32)
        inb = ids < len(gs)
        return np.where(inb, gs[np.where(inb, ids, 0)],
                        1.0).astype(np.float32)

    # ---- resumable cursor ------------------------------------------------
    def cursor(self, epoch: int, step: int) -> Dict:
        """The manifest's position: ``step`` meta-batches of ``epoch``
        consumed, and every field that shapes the batch ids."""
        return {"epoch": int(epoch), "step": int(step),
                "seed": int(self.seed), "meta_batch": self.meta_batch,
                "num_hosts": 1, "drop_last": self.drop_last,
                "kept_digest": kept_digest(self._kept), "growth": [],
                "kept_pop": self.n_samples}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The kept-set and grad scales for the checkpoint's extras (the
        manifest carries only the digest)."""
        out: Dict[str, np.ndarray] = {}
        if self._kept is not None:
            out["sampler_kept"] = np.asarray(self._kept, np.int64)
        if self._grad_scale is not None:
            out["sampler_grad_scale"] = np.asarray(self._grad_scale,
                                                   np.float32)
        return out

    def load_state(self, extras: Dict[str, np.ndarray],
                   cursor: Optional[Dict] = None) -> None:
        """Reinstall a checkpoint's kept-set and grad scales and check its
        cursor against this run: a different seed, meta-batch, host count,
        ``drop_last`` or kept-set would replay other batch ids."""
        if cursor is not None:
            mismatches = [
                f"{field} (manifest {cursor[field]!r} != run {have!r})"
                for field, have in (("seed", int(self.seed)),
                                    ("meta_batch", self.meta_batch),
                                    ("num_hosts", 1),
                                    ("drop_last", self.drop_last))
                if field in cursor and cursor[field] != have]
            if mismatches:
                raise ValueError(
                    "sampler resume: cursor mismatch; restoring this "
                    "checkpoint into the current run would reproduce "
                    "different batch ids: " + "; ".join(mismatches))
        self.apply_pruning(extras.get("sampler_kept"),
                           extras.get("sampler_grad_scale"))
        if cursor is not None:
            want = cursor.get("kept_digest", "full")
            have = kept_digest(self._kept)
            if want != have:
                raise ValueError(
                    f"sampler resume: kept-set digest mismatch "
                    f"(manifest {want!r} != restored {have!r})")
