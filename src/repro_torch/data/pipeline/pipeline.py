"""DataPipeline: source x sampler x prefetch, one trainer-facing object
(counterpart of ``repro/data/pipeline/pipeline.py``).

    pipe = DataPipeline(source, meta_batch, seed=0, place=make_placer(dev))
    for epoch in range(E):
        with pipe.epoch(epoch) as stream:      # device batches
            for batch in stream: ...

``epoch`` returns a background ``Prefetcher`` by default and the inline
``SyncStream`` when prefetch is off, so the epoch loop is the same either
way and its shutdown is clean.

Resume: ``cursor``/``state_arrays`` carry the sampler's position, the
source's fingerprint and a packed source's document kept-set through the
checkpoint (manifest and extras); ``load_state`` checks them against this
run, and ``epoch(epoch, start_step=s)`` then continues mid-epoch with the
batch ids the uninterrupted run would have produced. Not ported yet:
pruning hooks and growth.
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
        """Host batch ``step`` of ``epoch``, built on demand."""
        return self.source.batch(self.sampler.batch_ids(epoch, step))

    @property
    def doc_level(self) -> bool:
        """True when ES identity is the packed document, not the row."""
        return hasattr(self.source, "set_kept_docs")

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
