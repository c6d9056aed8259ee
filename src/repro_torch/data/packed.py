"""Document-packed source for token-level ES (a copy of
``repro/data/pipeline/sources.py:PackedSource``, :277-427).

Variable-length documents packed several to a row by greedy first-fit, at
most ``max_segments`` per row. Per row:

    tokens      (S,)   document tokens back to back, 0-padded tail
    labels      (S,)   next token within the same document; -1 at each
                       document's last token and at padding
    segment_ids (S,)   0 = padding, k in [1, max_segments] = k-th doc slot
    positions   (S,)   restart at 0 per document (RoPE sees local offsets)
    doc_ids     (M,)   global document id per slot, -1 = empty slot

ES identity is the document: ``n_docs`` sizes the score store, while
``batch`` ids are row indices. ``set_kept_docs`` masks dropped documents at
batch time (labels and slot ids -1) without re-packing, so row layout and
sample ids stay stable. Numpy only; the same seed gives the same arrays as
the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class PackedSource:
    PAD = 0

    def __init__(self, docs: Sequence[np.ndarray], seq_len: int,
                 max_segments: int = 4):
        self.seq_len = int(seq_len)
        self.max_segments = int(max_segments)
        docs = [np.asarray(d, np.int32) for d in docs]
        for i, d in enumerate(docs):
            if not 2 <= len(d) <= seq_len:
                raise ValueError(f"doc {i}: length {len(d)} outside "
                                 f"[2, seq_len={seq_len}]")
        self._n_docs = len(docs)
        # greedy first-fit: docs go to the first open row they fit in
        rows: List[List[int]] = []
        space: List[int] = []
        for i, d in enumerate(docs):
            for r in range(len(rows)):
                if len(d) <= space[r] and len(rows[r]) < self.max_segments:
                    rows[r].append(i)
                    space[r] -= len(d)
                    break
            else:
                rows.append([i])
                space.append(self.seq_len - len(d))
        n, S, M = len(rows), self.seq_len, self.max_segments
        self._tokens = np.full((n, S), self.PAD, np.int32)
        self._labels = np.full((n, S), -1, np.int32)
        self._segment_ids = np.zeros((n, S), np.int32)
        self._positions = np.zeros((n, S), np.int32)
        self._doc_ids = np.full((n, M), -1, np.int32)
        self._doc_tokens = 0
        for r, row in enumerate(rows):
            t = 0
            for m, i in enumerate(row):
                d = docs[i]
                L = len(d)
                self._tokens[r, t:t + L] = d
                self._labels[r, t:t + L - 1] = d[1:]   # last token: no target
                self._segment_ids[r, t:t + L] = m + 1
                self._positions[r, t:t + L] = np.arange(L)
                self._doc_ids[r, m] = i
                self._doc_tokens += L
                t += L
        self._kept = np.ones(self._n_docs, bool)
        self._grad_scale = np.ones(self._n_docs, np.float32)

    def __len__(self) -> int:
        return self._tokens.shape[0]

    @property
    def n_docs(self) -> int:
        return self._n_docs

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        ids = np.asarray(ids)
        slots = self._doc_ids[ids]                            # (B, M)
        kept = self._kept[np.clip(slots, 0, None)] & (slots >= 0)
        labels = self._labels[ids].copy()
        # seg value k indexes slot k-1; 0 (padding) stays masked regardless
        tok_kept = np.concatenate(
            [np.ones((len(ids), 1), bool), kept], axis=1)     # (B, M+1)
        seg = self._segment_ids[ids]
        labels[~np.take_along_axis(tok_kept, seg, axis=1)] = -1
        scale = np.where(slots >= 0,
                         self._grad_scale[np.clip(slots, 0, None)],
                         1.0).astype(np.float32)
        return {"tokens": self._tokens[ids].copy(),
                "labels": labels,
                "segment_ids": seg.copy(),
                "positions": self._positions[ids].copy(),
                "doc_ids": np.where(kept, slots, -1).astype(np.int32),
                "doc_grad_scale": scale,
                "sample_ids": ids.astype(np.int32)}

    def set_kept_docs(self, kept: np.ndarray,
                      grad_scale: Optional[np.ndarray] = None) -> None:
        kept = np.asarray(kept, bool)
        if kept.shape != (self._n_docs,):
            raise ValueError(f"kept mask of shape {kept.shape}, expected "
                             f"({self._n_docs},)")
        self._kept = kept.copy()
        if grad_scale is None:
            self._grad_scale = np.ones(self._n_docs, np.float32)
        else:
            self._grad_scale = np.asarray(grad_scale, np.float32).copy()

    def doc_state_arrays(self) -> Dict[str, np.ndarray]:
        """Checkpoint extras: the document kept-set and grad scales."""
        return {"doc_kept": self._kept.astype(np.int8),
                "doc_grad_scale": self._grad_scale}

    def load_doc_state(self, arrays: Dict[str, np.ndarray]) -> None:
        self.set_kept_docs(arrays["doc_kept"].astype(bool),
                           arrays["doc_grad_scale"])

    @property
    def pack_factor(self) -> float:
        """Mean documents per row."""
        return self._n_docs / max(len(self), 1)

    @property
    def padding_waste(self) -> float:
        """Fraction of token positions that are padding."""
        total = len(self) * self.seq_len
        return 1.0 - self._doc_tokens / max(total, 1)

    @classmethod
    def synthetic(cls, n_docs: int, seq_len: int, max_segments: int = 4,
                  vocab: int = 64, seed: int = 0) -> "PackedSource":
        """Variable-length docs with planted difficulty, pure in (seed, i):
        70% learnable (a short motif repeated to the doc length), 30% noise
        (uniform tokens). Lengths are skewed short so packing yields a real
        pack factor."""
        docs = []
        for i in range(n_docs):
            r = np.random.default_rng((seed, i))
            lo, hi = 4, max(6, (2 * seq_len) // max_segments)
            L = int(r.integers(lo, min(hi, seq_len) + 1))
            if i % 10 < 7:
                motif = r.integers(1, vocab, int(r.integers(2, 5)))
                d = np.tile(motif, L // len(motif) + 1)[:L]
            else:
                d = r.integers(1, vocab, L)
            docs.append(d.astype(np.int32))
        return cls(docs, seq_len, max_segments)
