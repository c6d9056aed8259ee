"""The data pipeline: sources, the epoch sampler and background prefetch
(counterpart of ``repro/data/pipeline``)."""
from ..packed import PackedSource
from .pipeline import DataPipeline
from .prefetch import (CudaPlacer, HostPlacer, Prefetcher, SyncStream,
                       make_placer)
from .sources import Source, SyntheticSource

__all__ = ["PackedSource", "DataPipeline", "CudaPlacer", "HostPlacer",
           "Prefetcher", "SyncStream", "make_placer", "Source",
           "SyntheticSource"]
