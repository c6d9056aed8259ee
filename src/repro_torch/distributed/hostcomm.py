"""Exact host collectives over a ``torch.distributed`` key-value store
(counterpart of ``repro/distributed/hostcomm.py:32-155``).

The score store's epoch-boundary legs (gather completion across processes,
the pruning statistics and candidate merges, checkpoint assembly) are host
numpy code. Across processes they need exact reductions of small payloads,
and they must not need a device collective: two processes that share one
GPU cannot form an NCCL group. ``HostComm`` rides the store that
``torch.distributed.init_process_group`` stands up (its ``TCPStore``), or
any ``torch.distributed.Store`` it is given. Payloads travel as
``np.save`` bytes, so dtype and shape come back exactly (f64 stays f64)
and a reduction built on them gives the same bits for any process count.

Every process must issue the same collectives in the same order (the SPMD
contract): they are matched by a per-instance sequence number. A payload's
keys are deleted after a trailing barrier, and a barrier's own keys by the
last process to leave it, so a long run does not grow the store. A payload
travels in pieces of at most ``_PIECE`` bytes: the ``TCPStore`` refuses a
value above 8 MiB, and a pruning leg's candidate lists at 2^24 rows are
some 100 MB.
"""
from __future__ import annotations

import datetime
import io
import itertools
from typing import List, Optional

import numpy as np
import torch

from .compression import WIRE_BLOCK

_TIMEOUT = datetime.timedelta(seconds=120)
_PIECE = 4 << 20
_NAMESPACE = "repro_hostcomm"


def _encode(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _decode(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


class HostComm:
    """Exact host collectives of one distributed run.

    One instance per process over a shared ``torch.distributed.Store``;
    every process calls each method the same number of times in the same
    order.
    """

    def __init__(self, store, process_index: int, process_count: int):
        self._store = store
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._seq = itertools.count()

    def _wait_all(self, key: str) -> None:
        """Block until every process reached ``key``; the last one to
        leave deletes the barrier's keys."""
        st = self._store
        if st.add(f"{key}/in", 1) == self.process_count:
            st.set(f"{key}/go", b"1")
        st.wait([f"{key}/go"], _TIMEOUT)
        if st.add(f"{key}/out", 1) == self.process_count:
            for k in ("in", "go", "out"):
                st.delete_key(f"{key}/{k}")

    def _put(self, key: str, raw: bytes) -> None:
        n = max(1, -(-len(raw) // _PIECE))
        for i in range(n):
            self._store.set(f"{key}/{i}", raw[i * _PIECE:(i + 1) * _PIECE])
        self._store.set(f"{key}/n", str(n))

    def _take(self, key: str) -> bytes:
        n = int(self._store.get(f"{key}/n"))
        return b"".join(self._store.get(f"{key}/{i}") for i in range(n))

    def _drop(self, key: str) -> None:
        n = int(self._store.get(f"{key}/n"))
        for k in [f"{key}/{i}" for i in range(n)] + [f"{key}/n"]:
            self._store.delete_key(k)

    def barrier(self, tag: str = "b") -> None:
        self._wait_all(f"{_NAMESPACE}/{next(self._seq)}/{tag}")

    def allgather(self, arr: np.ndarray) -> List[np.ndarray]:
        """Every process's array, in process order (shapes and dtypes may
        differ across processes: they ride the payload)."""
        arr = np.asarray(arr)
        tag = f"{_NAMESPACE}/{next(self._seq)}"
        self._put(f"{tag}/{self.process_index}", _encode(arr))
        self._wait_all(f"{tag}/ready")
        out = []
        for p in range(self.process_count):
            out.append(arr if p == self.process_index else
                       _decode(self._take(f"{tag}/{p}")))
        self._wait_all(f"{tag}/done")
        self._drop(f"{tag}/{self.process_index}")
        return out

    def allreduce_sum(self, x: np.ndarray) -> np.ndarray:
        """Elementwise sum over processes in process order, in the INPUT's
        dtype (f64 partials for the exact pruning statistics)."""
        x = np.asarray(x)
        parts = self.allgather(x.reshape(-1))
        out = parts[0].copy()
        for p in parts[1:]:
            out += p
        return out.reshape(x.shape)

    def allreduce_sum_compressed(self, x: np.ndarray) -> np.ndarray:
        """Elementwise f32 sum over processes with int8 codes and a f32
        scale per ``WIRE_BLOCK`` elements on the wire (the reference's numpy arithmetic).
        Lossy by one int8 grid step per contribution: meant for the int8
        store's wire gather, where each element has one non-zero
        contributor."""
        x32 = np.asarray(x, np.float32).reshape(-1)
        n = x32.size
        block = WIRE_BLOCK
        nb = max(1, -(-n // block))
        xp = np.pad(x32, (0, nb * block - n)).reshape(nb, block)
        scales = np.maximum(np.abs(xp).max(axis=1) / 127.0, 1e-12
                            ).astype(np.float32)
        q = np.clip(np.round(xp / scales[:, None]), -127, 127
                    ).astype(np.int8)
        parts_q = self.allgather(q)
        parts_s = self.allgather(scales)
        out = np.zeros((nb, block), np.float32)
        for qp, sp in zip(parts_q, parts_s):
            out += qp.astype(np.float32) * sp[:, None]
        return out.reshape(-1)[:n].reshape(np.shape(x))

    def allreduce_max(self, x) -> np.ndarray:
        x = np.asarray(x)
        parts = self.allgather(x.reshape(-1))
        out = parts[0]
        for p in parts[1:]:
            out = np.maximum(out, p)
        return out.reshape(x.shape)


_comm: Optional[HostComm] = None


def get_comm() -> Optional[HostComm]:
    """This process's ``HostComm`` over the default process group's store,
    or None outside a ``torch.distributed`` run of more than one process.

    Only a live comm is cached: a call before ``init_process_group`` (or
    after ``destroy_process_group``) finds none and probes again next
    time. Every process builds its comm from the same group, so the
    sequence numbers stay matched.
    """
    global _comm
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        _comm = None
        return None
    if _comm is None:
        from torch.distributed.distributed_c10d import _get_default_store
        _comm = HostComm(_get_default_store(), dist.get_rank(),
                         dist.get_world_size())
    return _comm
