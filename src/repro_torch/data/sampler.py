"""Epoch sampler: the (seed, epoch) permutation over the kept-set, its
meta-batches with their InfoBatch rescale, this host's slice of each, a
growing population and the resumable cursor (counterpart of
``repro/data/pipeline/sampler.py``).

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

The permutation is the same on every host; each host takes its
``host_slice`` of every global meta-batch (contiguous rows, or
``np.array_split`` shares of a partial last batch). A growing dataset
(``grow``) admits rows from the next epoch on, so the epoch being walked,
and a mid-epoch resume into it, keep their permutation; rows admitted
after the last prune are walked as kept until the next prune sees them.
The growth history and that boundary (``kept_pop``) ride the cursor.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Optional, Tuple

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
                 host_id: int = 0, num_hosts: int = 1,
                 drop_last: bool = True):
        if meta_batch % num_hosts or not 0 <= host_id < num_hosts:
            raise ValueError(f"sampler: host {host_id} of {num_hosts} with "
                             f"a meta-batch of {meta_batch}")
        self._base_n = int(n_samples)
        self.meta_batch = int(meta_batch)
        self.seed = seed
        self.host_id = int(host_id)
        self.num_hosts = int(num_hosts)
        self.drop_last = drop_last
        self._kept: Optional[np.ndarray] = None
        self._grad_scale: Optional[np.ndarray] = None
        # (first epoch, population) in effect order
        self._growth: List[Tuple[int, int]] = []
        # ids >= _kept_pop joined after the last prune: kept until the
        # next prune covers them
        self._kept_pop = self._base_n

    # ---- growing population ----------------------------------------------
    @property
    def n_samples(self) -> int:
        """The latest population."""
        return self._growth[-1][1] if self._growth else self._base_n

    def population(self, epoch: int) -> int:
        """The population in effect for ``epoch``."""
        n = self._base_n
        for e, tot in self._growth:
            if epoch >= e:
                n = tot
        return n

    def grow(self, n_new: int, epoch: int) -> None:
        """Admit ``n_new`` appended samples from epoch ``epoch + 1`` on
        (the current epoch's walk is already drawn)."""
        if n_new <= 0:
            raise ValueError(f"grow needs n_new > 0, got {n_new}")
        n_tot = self.n_samples + int(n_new)
        eff = int(epoch) + 1
        if self._growth and self._growth[-1][0] == eff:
            self._growth[-1] = (eff, n_tot)
        else:
            self._growth.append((eff, n_tot))

    # ---- set-level pruning's epoch hook ----------------------------------
    def apply_pruning(self, kept: Optional[np.ndarray],
                      grad_scale: Optional[np.ndarray] = None) -> None:
        """Install the kept ids (None: every id) and the optional (n,)
        per-sample grad scale for the epochs that follow."""
        self._kept = None if kept is None else np.asarray(kept)
        self._grad_scale = None if grad_scale is None \
            else np.asarray(grad_scale, np.float32)
        # the decision covers every row admitted so far
        self._kept_pop = self.n_samples

    @property
    def kept(self) -> Optional[np.ndarray]:
        return self._kept

    @property
    def grad_scale(self) -> Optional[np.ndarray]:
        return self._grad_scale

    # ---- permutation / shape ---------------------------------------------
    def _epoch_pool(self, epoch: int) -> np.ndarray:
        """The ids the epoch walks: the installed kept-set (or every id)
        and the rows admitted after that prune, within the epoch's
        population."""
        pop = self.population(epoch)
        if self._kept is None:
            return np.arange(pop)
        kept = self._kept[self._kept < pop]
        if pop > self._kept_pop:
            return np.concatenate([kept, np.arange(self._kept_pop, pop)])
        return kept

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self._epoch_pool(epoch))

    def steps_per_epoch(self, epoch: int = 0) -> int:
        """Meta-batches in ``epoch``, counted over its pool."""
        n = len(self._epoch_pool(epoch))
        return n // self.meta_batch if self.drop_last \
            else -(-n // self.meta_batch)

    def batch_ids(self, epoch: int, step: int) -> np.ndarray:
        """Global sample ids of meta-batch ``step`` of ``epoch`` (every
        host's)."""
        idx = self.epoch_indices(epoch)
        ids = idx[step * self.meta_batch:(step + 1) * self.meta_batch]
        if len(ids) < self.meta_batch and self.drop_last:
            return ids[:0]
        return ids

    def host_slice(self, ids: np.ndarray) -> np.ndarray:
        """This host's rows of a global batch: ``meta_batch // num_hosts``
        contiguous rows, or its ``np.array_split`` share of a partial last
        batch, so the hosts' slices stitch back in order."""
        if self.num_hosts == 1:
            return ids
        return np.array_split(ids, self.num_hosts)[self.host_id]

    def epoch_id_stream(self, epoch: int, start_step: int = 0
                        ) -> Iterator[Tuple[int, np.ndarray]]:
        """(step, this host's ids) for meta-batches ``start_step..`` of the
        epoch; the permutation is drawn once per epoch."""
        idx = self.epoch_indices(epoch)
        for b in range(start_step, self.steps_per_epoch(epoch)):
            yield b, self.host_slice(
                idx[b * self.meta_batch:(b + 1) * self.meta_batch])

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
        (admitted after it was drawn) takes the neutral 1.0."""
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
                "num_hosts": self.num_hosts, "drop_last": self.drop_last,
                "kept_digest": kept_digest(self._kept),
                "growth": [[int(e), int(n)] for e, n in self._growth],
                "kept_pop": int(self._kept_pop)}

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
        """Reinstall a checkpoint's kept-set, grad scales and growth and
        check its cursor against this run: a different seed, meta-batch,
        host count, ``drop_last`` or kept-set would replay other batch
        ids."""
        if cursor is not None:
            mismatches = [
                f"{field} (manifest {cursor[field]!r} != run {have!r})"
                for field, have in (("seed", int(self.seed)),
                                    ("meta_batch", self.meta_batch),
                                    ("num_hosts", self.num_hosts),
                                    ("drop_last", self.drop_last))
                if field in cursor and cursor[field] != have]
            if mismatches:
                raise ValueError(
                    "sampler resume: cursor mismatch; restoring this "
                    "checkpoint into the current run would reproduce "
                    "different batch ids: " + "; ".join(mismatches))
            self._growth = [(int(e), int(n))
                            for e, n in cursor.get("growth", [])]
        self.apply_pruning(extras.get("sampler_kept"),
                           extras.get("sampler_grad_scale"))
        if cursor is not None:
            self._kept_pop = int(cursor.get("kept_pop", self.n_samples))
            want = cursor.get("kept_digest", "full")
            have = kept_digest(self._kept)
            if want != have:
                raise ValueError(
                    f"sampler resume: kept-set digest mismatch "
                    f"(manifest {want!r} != restored {have!r})")
