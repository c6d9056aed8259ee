"""DataPipeline: source x sampler x prefetch, one trainer-facing object
(counterpart of ``repro/data/pipeline/pipeline.py``).

    pipe = DataPipeline(source, meta_batch, seed=0, place=make_placer(dev))
    for epoch in range(E):
        with pipe.epoch(epoch) as stream:      # device batches
            for batch in stream: ...

``epoch`` returns a background ``Prefetcher`` by default and the inline
``SyncStream`` when prefetch is off, so the epoch loop is the same either
way and its shutdown is clean.

Set-level pruning: ``apply_pruning(kept, grad_scale)`` installs the
next epochs' kept-set. A row source prunes through the sampler (dropped
rows leave the walk); a packed source prunes documents inside rows
through ``set_kept_docs`` (every row still streams, dropped documents'
labels and slot ids are masked). The packed source is what the prefetch
worker reads, so its kept-set is installed only between epochs: after
the previous epoch's stream has closed and before ``epoch`` builds the
next one.

Resume: ``cursor``/``state_arrays`` carry the sampler's position, the
source's fingerprint and the kept-set (the sampler's, or a packed
source's documents) through the checkpoint (manifest and extras);
``load_state`` checks them against this run, and ``epoch(epoch,
start_step=s)`` then continues mid-epoch with the batch ids and grad
scales the uninterrupted run would have produced. Not ported yet: growth.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from ..sampler import ESSampler
from .prefetch import Placer, Prefetcher, SyncStream
from .sources import Source, source_fingerprint


class DataPipeline:
    def __init__(self, source: Source, meta_batch: int, *, seed: int = 0,
                 drop_last: bool = True, prefetch: bool = True,
                 depth: int = 2, place: Optional[Placer] = None):
        self.source = source
        self.sampler = ESSampler(len(source), meta_batch, seed=seed,
                                 drop_last=drop_last)
        self.prefetch = prefetch
        self.depth = depth
        self.place = place

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Union[Prefetcher, SyncStream]:
        host_iter = self.sampler.epoch_batches(self.source, epoch,
                                               start_step)
        if self.prefetch:
            return Prefetcher(host_iter, depth=self.depth, place=self.place)
        return SyncStream(host_iter, place=self.place)

    def batch_at(self, epoch: int, step: int) -> Dict[str, np.ndarray]:
        """Host batch ``step`` of ``epoch``, built on demand with its grad
        scale (a resumed pipelined session rebuilds its held batch so)."""
        ids = self.sampler.batch_ids(epoch, step)
        batch = self.source.batch(ids)
        if self.sampler.grad_scale is not None:
            batch["grad_scale"] = self.sampler.grad_scale_for(ids)
        return batch

    @property
    def doc_level(self) -> bool:
        """True when ES identity is the packed document, not the row."""
        return hasattr(self.source, "set_kept_docs")

    def apply_pruning(self, kept: Optional[np.ndarray],
                      grad_scale: Optional[np.ndarray] = None) -> None:
        """Install the kept ids (None: every id) and their optional grad
        scale: through the sampler for a row source, through the source's
        document mask for a packed one (``kept`` then holds document ids).
        Call it between epochs, with no stream open."""
        if self.doc_level:
            n = self.source.n_docs
            if kept is None:
                self.source.set_kept_docs(np.ones(n, bool), None)
            else:
                mask = np.zeros(n, bool)
                mask[np.asarray(kept)] = True
                self.source.set_kept_docs(mask, grad_scale)
        else:
            self.sampler.apply_pruning(kept, grad_scale)

    @property
    def has_pruning(self) -> bool:
        """True once a pruning decision is installed (either form)."""
        if self.doc_level:
            return not self.source.doc_state_arrays()["doc_kept"].all()
        return self.sampler.kept is not None

    def steps_per_epoch(self, epoch: int = 0) -> int:
        return self.sampler.steps_per_epoch(epoch)

    # ---- resume ----------------------------------------------------------
    def cursor(self, epoch: int, step: int) -> Dict:
        cur = self.sampler.cursor(epoch, step)
        name, n = source_fingerprint(self.source)
        cur["source"] = {"kind": name, "n": n}
        return cur

    def state_arrays(self) -> Dict[str, np.ndarray]:
        arrays = self.sampler.state_arrays()
        if self.doc_level:
            arrays.update(self.source.doc_state_arrays())
        return arrays

    def load_state(self, extras: Dict[str, np.ndarray],
                   cursor: Optional[Dict] = None) -> None:
        if cursor is not None and "source" in cursor:
            name, n = source_fingerprint(self.source)
            if cursor["source"]["n"] != n:
                raise ValueError(
                    f"pipeline resume: source length changed "
                    f"({cursor['source']['n']} -> {n}); score rows would "
                    f"misalign")
        if self.doc_level and "doc_kept" in extras:
            self.source.load_doc_state(extras)
        self.sampler.load_state(extras, cursor)
