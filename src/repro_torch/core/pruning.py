"""Set-level (epoch-boundary) data selection: ESWP pruning and its
baselines (a copy of ``repro/core/pruning.py``, numpy only).

These run on the host between epochs (they decide which sample ids the
sampler walks), on a numpy snapshot of the score store. Every method
returns the kept ids and an optional per-sample gradient rescale
(InfoBatch).

  eswp      : keep (1-r)·n sampled WITHOUT replacement ∝ w_i (paper Alg. 1;
              randomized keep, Remark 1)
  infobatch : prune samples with loss below the mean w.p. r, rescale kept
              below-mean gradients by 1/(1-r)  (Qin et al. 2024)
  ucb       : keep top (1-r)·n by EMA-loss + exploration bonus (Raju et al.)
  ka        : KAKURENBO-style: hide the r·n lowest-loss samples, move back
              samples whose loss did not decay below ka_tau x last epoch's
              (ka_tau = 1: plain "loss increased" rule)
  random    : uniform (1-r)·n keep (ablation baseline)
  none      : keep everything

One implementation over a ``PruneSnapshot``: the row blocks a score
store exposes (``core.scores``). Global statistics come from block
reductions (exact f64 sums and extrema, so the InfoBatch 1/(1-r) rescale
stays unbiased), threshold methods merge per-block candidate top-k
lists, and every random draw is made by GLOBAL sample position. So the
same snapshot and the same ``np.random.Generator`` give the reference's
kept-set and ``grad_scale`` bit for bit, for any block layout. With
per-process score rows the snapshot carries a ``comm``
(``distributed.hostcomm.HostComm``: ``allgather``, ``allreduce_sum``,
``allreduce_max``) and the statistics and candidate merges reduce across
processes through it, exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PruneResult:
    kept: np.ndarray                    # (m,) int64 kept sample ids
    grad_scale: Optional[np.ndarray]    # (n,) f32 per-sample rescale or None


@dataclasses.dataclass
class PruneSnapshot:
    """Host view of the score store for set-level pruning.

    ``weights``/``losses``/``seen`` are this process's addressable row
    blocks (in offset order); ``offsets`` their first GLOBAL row; ``n``
    the logical store size (sum of all block lengths over every process).
    ``comm`` is the cross-process exchange when rows are process-owned
    (None: all rows are local and no exchange runs).
    """
    weights: List[np.ndarray]
    losses: List[np.ndarray]
    seen: Optional[List[np.ndarray]]
    offsets: np.ndarray
    n: int
    comm: object = None

    def block_ranges(self) -> List[Tuple[int, int]]:
        return [(int(o), int(o) + len(b))
                for o, b in zip(self.offsets, self.losses)]

    def assemble(self, blocks: List[np.ndarray]) -> np.ndarray:
        """Global (n,) array from per-block values (+ every other
        process's, allgathered, when rows are process-owned).  ``blocks``
        must be in ``block_ranges()`` order."""
        ranges = self.block_ranges()
        local = np.concatenate(blocks) if blocks else np.empty(0)
        out = np.zeros(self.n, local.dtype)
        if self.comm is not None:
            lens = np.asarray([hi - lo for lo, hi in ranges], np.int64)
            packed = self.comm.allgather(local)
            all_offs = self.comm.allgather(
                np.asarray(self.offsets, np.int64))
            all_lens = self.comm.allgather(lens)
            for buf, proc_offs, proc_lens in zip(packed, all_offs, all_lens):
                pos = 0
                for o, ln in zip(proc_offs, proc_lens):
                    out[o:o + ln] = buf[pos:pos + ln]
                    pos += ln
        else:
            for (lo, hi), b in zip(ranges, blocks):
                out[lo:hi] = b
        return out

    def full_losses(self) -> np.ndarray:
        """The assembled (n,) s-EMA snapshot (the trainer's
        ``prev_epoch_losses``)."""
        return self.assemble(self.losses)


@dataclasses.dataclass
class QuantPruneSnapshot(PruneSnapshot):
    """Snapshot from a quantized store: the f32 ``weights``/``losses``
    blocks are residual-corrected dequants (so the pruning statistics see
    the store's best-known values), while ``q_losses``/``q_scales`` keep
    the raw int8 codes + per-block scales for the cross-process exchange.

    ``wire=True`` makes ``full_losses`` ship the CODES (1 B/row + tiny
    scales) instead of f32 rows, and dequantize after the exchange — on
    every process AND with no comm at all, so the assembled snapshot is
    identical across topologies (residual corrections are dropped there;
    they are bounded by scale/2 and only affect the KA move-back
    comparison, never the Eq. 3.1 weights).
    """
    q_losses: List[np.ndarray] = None      # int8 row blocks (raw codes)
    q_scales: List[np.ndarray] = None      # per-block f32 scales
    q_block: int = 1024
    wire: bool = False

    def full_losses(self) -> np.ndarray:
        if not self.wire:
            return self.assemble(self.losses)
        offs = np.asarray(self.offsets, np.int64)
        lens = np.asarray([len(b) for b in self.q_losses], np.int64)
        sc_lens = np.asarray([len(b) for b in self.q_scales], np.int64)
        q_cat = (np.concatenate(self.q_losses) if self.q_losses
                 else np.empty(0, np.int8))
        sc_cat = (np.concatenate(self.q_scales) if self.q_scales
                  else np.empty(0, np.float32))
        if self.comm is not None:
            all_q = self.comm.allgather(q_cat)          # int8 on the wire
            all_sc = self.comm.allgather(sc_cat)
            all_offs = self.comm.allgather(offs)
            all_lens = self.comm.allgather(lens)
            all_sclens = self.comm.allgather(sc_lens)
        else:
            all_q, all_sc = [q_cat], [sc_cat]
            all_offs, all_lens, all_sclens = [offs], [lens], [sc_lens]
        out = np.zeros(self.n, np.float32)
        for qb, scb, ob, lb, slb in zip(all_q, all_sc, all_offs,
                                        all_lens, all_sclens):
            qpos = spos = 0
            for o, ln, sl in zip(ob, lb, slb):
                q = qb[qpos:qpos + ln]
                sc = scb[spos:spos + sl]
                blk = -(-int(ln) // int(sl))
                pad = int(sl) * blk - int(ln)
                out[o:o + ln] = (np.pad(q.astype(np.float32), (0, pad))
                                 .reshape(int(sl), blk)
                                 * sc[:, None]).reshape(-1)[:ln]
                qpos += int(ln)
                spos += int(sl)
        return out


def _local_topk(keys: np.ndarray, k: int) -> np.ndarray:
    k = min(k, len(keys))
    return np.argpartition(-keys, k - 1)[:k] if k else np.empty(0, np.int64)


def _merge_candidates(snap: PruneSnapshot, keys: List[np.ndarray],
                      ids: List[np.ndarray], k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Global top-k (ids, keys) from per-block candidate lists.

    Exact: the global top-k holds at most k entries per block, so each
    block pre-filtering to its local top-min(k, |block|) loses nothing.
    Candidate lists are allgathered across processes when rows are
    process-owned — O(k * blocks) scalars, never the (n,) store.
    """
    keys_cat = np.concatenate(keys) if keys else np.empty(0)
    ids_cat = np.concatenate(ids) if ids else np.empty(0, np.int64)
    if snap.comm is not None:
        keys_cat = np.concatenate(snap.comm.allgather(keys_cat))
        ids_cat = np.concatenate(snap.comm.allgather(ids_cat))
    k = min(k, len(ids_cat))
    if k <= 0:
        return ids_cat[:0], keys_cat[:0]
    sel = np.argpartition(-keys_cat, k - 1)[:k]
    return ids_cat[sel], keys_cat[sel]


def prune_epoch_snapshot(method: str, rng: np.random.Generator,
                         snap: PruneSnapshot, *,
                         prev_losses: Optional[np.ndarray] = None,
                         ratio: float = 0.2, ucb_c: float = 1.0,
                         ka_tau: float = 1.0) -> PruneResult:
    """Pick kept indices for the next epoch from a score-store snapshot.

    weights: ES w_i blocks; losses: latest per-sample losses (the s_i EMA
    works as a robust proxy); prev_losses/seen feed KA / UCB variants.
    ka_tau is the KA move-back decay tolerance: a hidden sample stays
    hidden only if its loss decayed below ka_tau x last epoch's (1.0 =
    plain comparison).  Every process of a multi-host run returns the SAME
    PruneResult (global ids, (n,) grad_scale).
    """
    n = snap.n
    n_keep = max(1, int(round((1.0 - ratio) * n)))

    if method in ("none", "baseline", "es", "loss", "order", "uniform"):
        return PruneResult(np.arange(n), None)

    if method == "eswp":
        # Gumbel keys drawn by GLOBAL position: every process/block layout
        # sees the same draw, so the kept-set is layout-invariant
        g = rng.gumbel(size=n)
        keys, ids = [], []
        for (lo, hi), w in zip(snap.block_ranges(), snap.weights):
            key = np.log(np.maximum(w.astype(np.float64), 1e-20)) + g[lo:hi]
            loc = _local_topk(key, n_keep)
            keys.append(key[loc])
            ids.append(loc + lo)
        kept, _ = _merge_candidates(snap, keys, ids, n_keep)
        return PruneResult(np.sort(kept), None)

    if method == "random":
        kept = rng.choice(n, size=n_keep, replace=False)
        return PruneResult(np.sort(kept), None)

    if method == "infobatch":
        # global mean from per-block f64 partial sums (allreduced across
        # processes) — an f32 mean would diverge at ~1e-7 rel and flip
        # below-mean flags near the threshold, biasing the 1/(1-r) rescale
        partial = np.asarray(sum(float(x.sum(dtype=np.float64))
                                 for x in snap.losses), np.float64)
        if snap.comm is not None:
            partial = snap.comm.allreduce_sum(partial)
        mean = float(partial) / n
        u = rng.random(n)                  # global-position draw
        drop = np.zeros(n, bool)
        scale = np.ones(n, np.float32)
        for (lo, hi), losses in zip(snap.block_ranges(), snap.losses):
            below = losses < mean
            blk_drop = below & (u[lo:hi] < ratio)
            drop[lo:hi] = blk_drop
            scale[lo:hi][below & ~blk_drop] = 1.0 / (1.0 - ratio)
        if snap.comm is not None:
            # each process computed only its rows: assemble the global
            # decision (keep-masks and scales are (rows,) bools/f32 — the
            # only O(n) exchange, once per epoch)
            ranges = snap.block_ranges()
            drop = snap.assemble([drop[lo:hi] for lo, hi in ranges])
            scale = snap.assemble([scale[lo:hi] for lo, hi in ranges])
        kept = np.nonzero(~drop)[0]
        return PruneResult(kept, scale)

    if method == "ucb":
        seen = snap.seen or [np.ones(len(x)) for x in snap.losses]
        t = np.asarray(max(int(x.max()) for x in seen), np.int64)
        if snap.comm is not None:
            t = snap.comm.allreduce_max(t)
        t = max(1, int(t))
        keys, ids = [], []
        for (lo, hi), losses, cnt in zip(snap.block_ranges(), snap.losses,
                                         seen):
            cnt = np.maximum(cnt, 1)
            score = losses + ucb_c * np.sqrt(np.log(t + 1.0) / cnt)
            loc = _local_topk(score, n_keep)
            keys.append(score[loc])
            ids.append(loc + lo)
        kept, _ = _merge_candidates(snap, keys, ids, n_keep)
        return PruneResult(np.sort(kept), None)

    if method == "ka":
        n_hide = n - n_keep
        # global bottom-n_hide from per-block bottom candidates (negated
        # keys -> top-k machinery); move-back then consults prev_losses by
        # global id.  The hidden samples' losses ride the candidate keys,
        # so no process needs foreign loss rows.
        keys, ids = [], []
        for (lo, hi), losses in zip(snap.block_ranges(), snap.losses):
            neg = -losses.astype(np.float64)
            loc = _local_topk(neg, n_hide)
            keys.append(neg[loc])
            ids.append(loc + lo)
        hidden, hkeys = _merge_candidates(snap, keys, ids, n_hide)
        if prev_losses is not None and n_hide > 0:
            # move-back: a hidden sample re-enters unless its loss decayed
            # below the ka_tau fraction of last epoch's — ka_tau = 1 is
            # the plain "loss went up" rule, ka_tau < 1 demands a real
            # improvement before a sample may stay hidden (hysteresis
            # against hiding samples the model is still learning)
            hidden_losses = (-hkeys).astype(np.float32)
            worse = hidden_losses > prev_losses[hidden] * ka_tau
            hidden = np.setdiff1d(hidden, hidden[worse],
                                  assume_unique=False)
        mask = np.ones(n, bool)
        mask[hidden] = False
        return PruneResult(np.nonzero(mask)[0], None)

    raise ValueError(f"unknown pruning method {method!r}")


def prune_epoch(method: str, rng: np.random.Generator, *,
                weights: np.ndarray, losses: np.ndarray,
                prev_losses: Optional[np.ndarray] = None,
                seen: Optional[np.ndarray] = None,
                ratio: float = 0.2, ucb_c: float = 1.0,
                ka_tau: float = 1.0) -> PruneResult:
    """``prune_epoch_snapshot`` over full host arrays (the one-block
    snapshot) — the reference the block/shard layouts are pinned to."""
    snap = PruneSnapshot(
        weights=[np.asarray(weights)], losses=[np.asarray(losses)],
        seen=None if seen is None else [np.asarray(seen)],
        offsets=np.asarray([0], np.int64), n=int(len(weights)))
    return prune_epoch_snapshot(method, rng, snap, prev_losses=prev_losses,
                                ratio=ratio, ucb_c=ucb_c, ka_tau=ka_tau)
