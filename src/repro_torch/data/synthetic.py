"""Deterministic synthetic LM data with a planted difficulty distribution
(a copy of ``repro/data/synthetic.py``: the same seed gives the same
tokens in both packages).

No datasets ship with the repository, so end-to-end runs use a
seeded token stream where *data selection has something to find*:

  easy   (50%): low-entropy periodic patterns — fitted quickly; a good
                selector should stop spending backprop on them.
  medium (30%): order-1 Markov chains with per-sample transition keys.
  hard   (15%): high-entropy streams — keep contributing gradient signal.
  noise  ( 5%): uniformly random tokens (unlearnable) — the ES "difference"
                term (Eq. 3.2) damps their weights: losses stay high but do
                not *decrease*, so pure-loss methods over-sample them while
                ES backs off.

Token generation is a pure function of (seed, sample_id) — any host can
materialize any sample without coordination, which is what makes the
sharded loader and ESWP pruning trivially consistent across hosts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

CLASSES = ("easy", "medium", "hard", "noise")
CLASS_FRACS = (0.50, 0.30, 0.15, 0.05)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_samples: int = 4096
    seq_len: int = 64
    vocab_size: int = 128
    seed: int = 0
    class_fracs: Tuple[float, ...] = CLASS_FRACS


class SyntheticLM:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_samples
        bounds = np.cumsum([int(f * n) for f in cfg.class_fracs])
        cls = np.zeros(n, np.int32)
        cls[bounds[0]:bounds[1]] = 1
        cls[bounds[1]:bounds[2]] = 2
        cls[bounds[2]:] = 3
        self.sample_class = rng.permutation(cls)
        # per-sample seeds + shared Markov backbone
        self.sample_seed = rng.integers(0, 2 ** 31 - 1, size=n)
        v = cfg.vocab_size
        trans_logits = rng.normal(size=(v, v)) * 2.0
        self.trans = np.argsort(-trans_logits, axis=1)[:, :4]  # top-4 continuations

    def __len__(self) -> int:
        return self.cfg.n_samples

    def class_of(self, ids: np.ndarray) -> np.ndarray:
        return self.sample_class[ids]

    def tokens(self, ids: np.ndarray) -> np.ndarray:
        """ids: (B,) -> tokens (B, S) int32, deterministic per id."""
        cfg = self.cfg
        B = len(ids)
        out = np.empty((B, cfg.seq_len), np.int32)
        for j, sid in enumerate(np.asarray(ids)):
            r = np.random.default_rng(int(self.sample_seed[sid]))
            c = int(self.sample_class[sid])
            if c == 0:      # easy: short period repetition
                period = 2 + int(self.sample_seed[sid]) % 6
                motif = r.integers(0, cfg.vocab_size, period)
                reps = -(-cfg.seq_len // period)
                out[j] = np.tile(motif, reps)[:cfg.seq_len]
            elif c == 1:    # medium: walk the shared Markov top-4 graph
                t = np.empty(cfg.seq_len, np.int64)
                t[0] = r.integers(0, cfg.vocab_size)
                choices = r.integers(0, 4, cfg.seq_len)
                for k in range(1, cfg.seq_len):
                    t[k] = self.trans[t[k - 1], choices[k]]
                out[j] = t
            elif c == 2:    # hard: wide Markov (top-4 of a rotated graph)
                t = np.empty(cfg.seq_len, np.int64)
                t[0] = r.integers(0, cfg.vocab_size)
                choices = r.integers(0, 4, cfg.seq_len)
                shift = 1 + int(self.sample_seed[sid]) % (cfg.vocab_size - 1)
                for k in range(1, cfg.seq_len):
                    t[k] = (self.trans[t[k - 1], choices[k]] + shift) % cfg.vocab_size
                out[j] = t
            else:           # noise: uniform
                out[j] = r.integers(0, cfg.vocab_size, cfg.seq_len)
        return out

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        toks = self.tokens(ids)
        labels = np.concatenate(
            [toks[:, 1:], np.full((len(ids), 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels.astype(np.int32),
                "sample_ids": np.asarray(ids, np.int32)}
