"""The data pipeline: sources, the epoch sampler, background prefetch and
admission batching (counterpart of ``repro/data/pipeline``)."""
from ..packed import PackedSource
from .admission import (AdmissionController, AdmissionResult,
                        es_admission_filter)
from .pipeline import DataPipeline
from .prefetch import (CudaPlacer, HostPlacer, Prefetcher, SyncStream,
                       make_placer)
from .sources import (PackedSFTSource, ShardedFileSource, Source,
                      StreamingSource, SyntheticSource, TokenBinSource,
                      get_source, write_token_bin)

__all__ = ["PackedSource", "AdmissionController", "AdmissionResult",
           "es_admission_filter", "DataPipeline", "CudaPlacer", "HostPlacer",
           "Prefetcher", "SyncStream", "make_placer", "PackedSFTSource",
           "ShardedFileSource", "Source", "StreamingSource",
           "SyntheticSource", "TokenBinSource", "get_source",
           "write_token_bin"]
