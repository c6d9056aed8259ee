"""Background prefetch: batch t+1 is built and copied to the device while
the device runs step t (counterpart of
``repro/data/pipeline/prefetch.py``).

``Prefetcher`` runs the host build and the placement on a worker thread
feeding a bounded queue: depth 2 by default (double buffering), so the
worker blocks when it is ``depth`` batches ahead (backpressure);
``close()`` stops it even when the queue is full and joins it; a worker
exception re-raises in the consumer. ``SyncStream`` has the same
interface and builds each batch inline, on the calling thread (the
``--no-prefetch`` path).

A placer has two halves. ``placer(host_batch)`` runs on the worker:
``CudaPlacer`` copies every array into pinned memory and from there to
the card with a non-blocking copy on its own stream, then records an
event. ``placer.ready(item)`` runs on the consumer before the step reads
the batch: the consumer's stream waits on that event, and every tensor is
recorded on that stream, so the caching allocator does not hand the
block back to the copy stream while the step still reads it.
``HostPlacer`` is the CPU placement (``torch.from_numpy``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Protocol

import numpy as np
import torch

HostBatch = Dict[str, np.ndarray]
Batch = Dict[str, torch.Tensor]


class Placer(Protocol):
    def __call__(self, batch: HostBatch) -> Any: ...

    def ready(self, item: Any) -> Batch: ...


class HostPlacer:
    """CPU tensors over the numpy arrays."""

    def __call__(self, batch: HostBatch) -> Batch:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}

    def ready(self, item: Batch) -> Batch:
        return item


class CudaPlacer:
    """Pinned host copy, then a non-blocking copy on the placer's own
    stream, then an event the consumer waits on.

    Each batch pins fresh host memory (``pin_memory``): PyTorch's caching
    host allocator records the copy's stream on the pinned block and does
    not reuse it before the copy has completed, so no pinned buffer is
    rewritten while its copy is in flight.
    """

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CudaPlacer: {device} is not a CUDA device")
        if device.index is None:        # the caller's current device
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = torch.cuda.Stream(device=device)

    def __call__(self, batch: HostBatch):
        torch.cuda.set_device(self.device)      # the worker thread's device
        with torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return out, copied

    def ready(self, item) -> Batch:
        out, copied = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(copied)
        for t in out.values():
            t.record_stream(stream)
        return out


def make_placer(device) -> Placer:
    """The placer for ``device``: CUDA copies on their own stream, the CPU
    wraps the arrays."""
    device = torch.device(device)
    if device.type == "cuda":
        return CudaPlacer(device)
    if device.type == "cpu":
        return HostPlacer()
    raise ValueError(f"no placer for device {device}")


class _Sentinel:
    __slots__ = ("err",)

    def __init__(self, err: Optional[BaseException] = None):
        self.err = err


class Prefetcher:
    """Iterate device batches built ``depth`` batches ahead on a worker.

    A context manager too; iteration ends when the underlying iterable
    does, or right after ``close()``. ``place`` defaults to the CUDA
    placer of the current device.
    """

    def __init__(self, batches: Iterable[HostBatch], *, depth: int = 2,
                 place: Optional[Placer] = None):
        self.depth = max(1, int(depth))
        self._place = place if place is not None else make_placer("cuda")
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(iter(batches),), daemon=True,
            name="repro-torch-prefetch")
        self._thread.start()

    # -- worker ------------------------------------------------------------
    def _worker(self, it: Iterator[HostBatch]) -> None:
        try:
            for batch in it:
                if self._stop.is_set():
                    break
                item = self._place(batch)
                # bounded-blocking put that still honours shutdown
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    break
            self._finish(None)
        except BaseException as e:     # re-raised in the consumer
            self._finish(e)

    def _finish(self, err: Optional[BaseException]) -> None:
        sentinel = _Sentinel(err)
        while True:
            try:
                self._q.put(sentinel, timeout=0.05)
                return
            except queue.Full:
                if self._stop.is_set():
                    return             # the consumer is gone

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Batch:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, _Sentinel):
            self._done = True
            if item.err is not None:
                raise item.err
            raise StopIteration
        return self._place.ready(item)

    def close(self) -> None:
        """Stop the worker and join it; safe to call more than once."""
        self._stop.set()
        self._done = True
        while True:                    # unblock a worker stuck on put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SyncStream:
    """``Prefetcher``'s synchronous twin: each batch is built and placed
    inline on the calling thread."""

    def __init__(self, batches: Iterable[HostBatch], *,
                 place: Optional[Placer] = None):
        self._it = iter(batches)
        self._place = place if place is not None else make_placer("cuda")

    def __iter__(self) -> "SyncStream":
        return self

    def __next__(self) -> Batch:
        return self._place.ready(self._place(next(self._it)))

    def close(self) -> None:
        pass

    def __enter__(self) -> "SyncStream":
        return self

    def __exit__(self, *exc) -> None:
        pass
