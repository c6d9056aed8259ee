"""Batch sources of the data pipeline (a numpy copy of
``repro/data/pipeline/sources.py``: the protocol and the synthetic adapter
:46-74, the file sources :81-275, ``StreamingSource`` and ``get_source``
:434-555).

A source has ``__len__`` and ``batch(ids) -> dict`` with at least
``tokens (B, S) i32``, ``labels (B, S) i32`` (-1 = masked) and
``sample_ids (B,) i32``; sample identity is positional and stable, so a
score-store row always belongs to the same example.

  SyntheticSource   : adapter over the in-memory ``SyntheticLM``;
  TokenBinSource    : windows of ``seq_len + 1`` tokens over a memory-
                      mapped flat token file (``write_token_bin``);
  ShardedFileSource : the same windows over many files, each mapped
                      lazily and kept in a small LRU;
  PackedSFTSource   : (prompt, response) pairs, labels on the response
                      span only;
  PackedSource      : documents packed several to a row (``data/packed.py``);
  StreamingSource   : a growing wrapper over any of them: appended rows
                      take the ids after the base's, never re-indexed.

Every batch is the reference's to the bit: the same windows, labels and
ids from the same files.
"""
from __future__ import annotations

import collections
import glob
import json
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from ..packed import PackedSource
from ..synthetic import SyntheticConfig, SyntheticLM


class Source(Protocol):
    def __len__(self) -> int: ...

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]: ...


class SyntheticSource:
    """Adapter over ``SyntheticLM``; the dataset stays reachable as
    ``.ds``."""

    def __init__(self, ds: Optional[SyntheticLM] = None, **cfg_kw):
        self.ds = ds or SyntheticLM(SyntheticConfig(**cfg_kw))

    def __len__(self) -> int:
        return len(self.ds)

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        return self.ds.batch(ids)


def write_token_bin(path: str, tokens: np.ndarray,
                    dtype=np.uint16) -> Path:
    """Write a flat token stream as a ``.bin`` (the TokenBinSource
    format)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.asarray(tokens).astype(dtype).tofile(p)
    return p


def _windows(ids: np.ndarray, S: int, window) -> Dict[str, np.ndarray]:
    """tokens/labels of the ``S + 1``-token windows ``window(j, sid)``."""
    win = np.empty((len(ids), S + 1), np.int32)
    for j, sid in enumerate(ids):
        win[j] = window(j, int(sid))
    return {"tokens": win[:, :-1].astype(np.int32),
            "labels": win[:, 1:].astype(np.int32),
            "sample_ids": ids.astype(np.int32)}


class TokenBinSource:
    """Sample ``i`` is ``tokens[i*S : i*S + S + 1]`` of a memory-mapped
    flat token file: the extra token gives the shifted labels, so
    neighbouring samples share one boundary token. Only the batch's
    windows are read."""

    def __init__(self, path: str, seq_len: int, dtype=np.uint16):
        self.path = Path(path)
        self.seq_len = int(seq_len)
        self._mm = np.memmap(self.path, dtype=dtype, mode="r")
        self._n = max(0, (len(self._mm) - 1) // self.seq_len)
        if self._n == 0:
            raise ValueError(f"{path}: needs > seq_len+1={seq_len + 1} "
                             f"tokens, has {len(self._mm)}")

    def __len__(self) -> int:
        return self._n

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        S = self.seq_len
        return _windows(np.asarray(ids), S,
                        lambda j, sid: self._mm[sid * S:sid * S + S + 1])


class ShardedFileSource:
    """TokenBin windows over many files: global ids run through the
    files' windows in the given order. Files are mapped on first use and
    at most ``max_open`` stay mapped (least recently used first out)."""

    def __init__(self, paths: Sequence[str], seq_len: int,
                 dtype=np.uint16, max_open: int = 8):
        if not paths:
            raise ValueError("ShardedFileSource: no shard paths")
        self.paths = [Path(p) for p in paths]
        self.seq_len = int(seq_len)
        self.dtype = dtype
        self.max_open = max(1, int(max_open))
        self._open: "collections.OrderedDict[int, np.memmap]" = \
            collections.OrderedDict()
        counts = [max(0, (p.stat().st_size // np.dtype(dtype).itemsize - 1)
                      // self.seq_len) for p in self.paths]
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        if self._offsets[-1] == 0:
            raise ValueError("ShardedFileSource: every shard is shorter "
                             f"than seq_len+1={self.seq_len + 1} tokens")

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _shard(self, k: int) -> np.memmap:
        mm = self._open.get(k)
        if mm is None:
            mm = np.memmap(self.paths[k], dtype=self.dtype, mode="r")
            self._open[k] = mm
            while len(self._open) > self.max_open:
                self._open.popitem(last=False)
        else:
            self._open.move_to_end(k)
        return mm

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        S = self.seq_len
        ids = np.asarray(ids)
        shard_of = np.searchsorted(self._offsets, ids, side="right") - 1

        def window(j, sid):
            k = int(shard_of[j])
            lo = (sid - int(self._offsets[k])) * S
            return self._shard(k)[lo:lo + S + 1]
        return _windows(ids, S, window)


class PackedSFTSource:
    """(prompt, response) token pairs laid out as ``[prompt | response |
    pad]`` in ``seq_len``. ``labels[t]`` is the next token only where that
    token lies in the response; prompt and padding positions are -1, so a
    sample's loss (its ES score) measures the response alone."""

    PAD = 0

    def __init__(self, prompts: Sequence[Sequence[int]],
                 responses: Sequence[Sequence[int]], seq_len: int):
        assert len(prompts) == len(responses)
        self.seq_len = int(seq_len)
        self._tokens = np.full((len(prompts), seq_len), self.PAD, np.int32)
        self._labels = np.full((len(prompts), seq_len), -1, np.int32)
        self._resp_len = np.zeros(len(prompts), np.int32)
        for i, (p, r) in enumerate(zip(prompts, responses)):
            seq = np.asarray(list(p) + list(r), np.int32)[:seq_len]
            self._tokens[i, :len(seq)] = seq
            # position t is supervised iff token t+1 is a response token
            lo = max(len(p) - 1, 0)
            hi = max(min(len(p) + len(r), seq_len) - 1, lo)
            self._labels[i, lo:hi] = seq[lo + 1:hi + 1]
            self._resp_len[i] = hi - lo

    def __len__(self) -> int:
        return self._tokens.shape[0]

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        ids = np.asarray(ids)
        return {"tokens": self._tokens[ids].copy(),
                "labels": self._labels[ids].copy(),
                "sample_ids": ids.astype(np.int32)}

    @classmethod
    def from_jsonl(cls, path: str, seq_len: int) -> "PackedSFTSource":
        """Rows of ``{"prompt": [ids...], "response": [ids...]}``."""
        prompts: List[List[int]] = []
        responses: List[List[int]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                prompts.append([int(t) for t in row["prompt"]])
                responses.append([int(t) for t in row["response"]])
        return cls(prompts, responses, seq_len)

    @classmethod
    def synthetic(cls, n: int, seq_len: int, vocab: int = 64,
                  seed: int = 0) -> "PackedSFTSource":
        """SFT pairs with a planted difficulty split, pure in (seed, i):
        70 % learnable (the response reverses, shifts by one or echoes
        the prompt), 30 % random responses."""
        prompts, responses = [], []
        for i in range(n):
            r = np.random.default_rng((seed, i))
            p_len = int(r.integers(4, max(5, seq_len // 4)))
            prompt = r.integers(1, vocab, p_len)
            kind = i % 10
            if kind < 3:
                resp = prompt[::-1]
            elif kind < 5:
                resp = (prompt + 1) % vocab
            elif kind < 7:
                resp = prompt.copy()
            else:
                resp = r.integers(1, vocab, p_len)
            prompts.append(prompt.tolist())
            responses.append(resp.tolist())
        return cls(prompts, responses, seq_len)


class StreamingSource:
    """A dataset that grows while the sampler walks it.

    ``append`` admits (tokens, labels) rows at the end of the id space and
    returns their ids: ids below the base's length stay the base's rows,
    appended ones take the next ids in admission order and are never
    re-indexed. Appends never change an existing row, so a prefetch worker
    batching ids it was already given races with admission safely. The
    appended rows ride the checkpoint's extras (``stream_state_arrays``/
    ``load_stream_state``): the base is rebuilt from the config, the
    stream is not.
    """

    def __init__(self, base: Source):
        self.base = base
        self._base_n = len(base)
        self.seq_len = int(base.batch(np.asarray([0]))["tokens"].shape[1])
        self._tokens: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def __len__(self) -> int:
        return self._base_n + len(self._tokens)

    @property
    def n_streamed(self) -> int:
        return len(self._tokens)

    def append(self, tokens: np.ndarray, labels: np.ndarray) -> np.ndarray:
        """Admit rows; returns their global sample ids, (M,) int64."""
        tokens = np.atleast_2d(np.asarray(tokens, np.int32))
        labels = np.atleast_2d(np.asarray(labels, np.int32))
        if tokens.shape != labels.shape or tokens.shape[1] != self.seq_len:
            raise ValueError(
                f"append: want (M, {self.seq_len}) token/label rows, got "
                f"{tokens.shape} / {labels.shape}")
        lo = len(self)
        for t, l in zip(tokens, labels):
            self._tokens.append(t.copy())
            self._labels.append(l.copy())
        return np.arange(lo, lo + len(tokens), dtype=np.int64)

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        ids = np.asarray(ids)
        is_new = ids >= self._base_n
        if not is_new.any():
            return self.base.batch(ids)
        tokens = np.empty((len(ids), self.seq_len), np.int32)
        labels = np.empty((len(ids), self.seq_len), np.int32)
        old = ~is_new
        if old.any():
            b = self.base.batch(ids[old])
            tokens[old] = b["tokens"]
            labels[old] = b["labels"]
        for j in np.nonzero(is_new)[0]:
            k = int(ids[j]) - self._base_n
            tokens[j] = self._tokens[k]
            labels[j] = self._labels[k]
        return {"tokens": tokens, "labels": labels,
                "sample_ids": ids.astype(np.int32)}

    def stream_state_arrays(self) -> Dict[str, np.ndarray]:
        if not self._tokens:
            return {}
        return {"stream_tokens": np.stack(self._tokens),
                "stream_labels": np.stack(self._labels)}

    def load_stream_state(self, extras: Dict[str, np.ndarray]) -> None:
        """Reinstall checkpointed streamed rows (replacing any)."""
        self._tokens = [np.asarray(t, np.int32)
                        for t in extras.get("stream_tokens", [])]
        self._labels = [np.asarray(l, np.int32)
                        for l in extras.get("stream_labels", [])]


SOURCES = ("synthetic", "tokens", "sharded", "sft", "packed")


def get_source(kind: str, *, path: Optional[str] = None,
               n_samples: int = 1024, seq_len: int = 64,
               vocab_size: int = 64, seed: int = 0,
               max_segments: int = 4) -> Source:
    """The trainer's ``--source``: ``synthetic``, ``tokens`` (a token bin
    at ``path``), ``sharded`` (a glob of token bins in ``path``), ``sft``
    (JSONL at ``path``, or the synthetic SFT set without one) or
    ``packed`` (synthetic documents, ``n_samples`` of them)."""
    if kind == "synthetic":
        return SyntheticSource(n_samples=n_samples, seq_len=seq_len,
                               vocab_size=vocab_size, seed=seed)
    if kind == "tokens":
        if not path:
            raise ValueError("--data-path required for --source tokens")
        return TokenBinSource(path, seq_len)
    if kind == "sharded":
        if not path:
            raise ValueError("--data-path (glob) required for --source "
                             "sharded")
        return ShardedFileSource(sorted(glob.glob(path, recursive=True)),
                                 seq_len)
    if kind == "sft":
        if path:
            return PackedSFTSource.from_jsonl(path, seq_len)
        return PackedSFTSource.synthetic(n_samples, seq_len,
                                         vocab=vocab_size, seed=seed)
    if kind == "packed":
        return PackedSource.synthetic(n_samples, seq_len,
                                      max_segments=max_segments,
                                      vocab=vocab_size, seed=seed)
    raise ValueError(f"unknown source kind {kind!r}")


def source_fingerprint(source: Source) -> Tuple[str, int]:
    """(class name, length): recorded in the checkpoint manifest, so that
    a resume against another corpus fails instead of misaligning score
    rows."""
    return type(source).__name__, len(source)
