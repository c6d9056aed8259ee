"""Evolved Sampling score state, paper Eq. (3.1) (counterpart of
``repro/core/scores.py``: ``ScoreSharding`` :69-115, the store protocol
:178-268, ``ReplicatedStore`` :271-325, ``ShardedStore`` :328-641, the
int8 ``QuantizedStore`` :644-1309, ``make_store`` :1312-1325, and the
explicit forms of Eq. (3.1), Eq. (3.2) and Thm. 3.2 :1332-1372).

    w_i(t) = beta1 * s_i(t-1) + (1-beta1) * l_i(theta(t))
    s_i(t) = beta2 * s_i(t-1) + (1-beta2) * l_i(theta(t))

The (n,) state is the trainer's only O(n_train) state. Every store
updates it IN PLACE (the fused kernels write the leaves where they lie),
so no step copies it. Its placement is the store's business, behind one
protocol that the engine, the trainer and the checkpointer speak:

  ``ReplicatedStore``  the (n,) tensors on one device.
  ``ShardedStore``     contiguous row blocks over a ``ScoreSharding``'s
                       device list (block d owns rows [d n/D, (d+1) n/D);
                       the list may repeat a device). A leaf field is then
                       a list of D tensors, each on its block's device.
                       An update sends the (B,) ids and losses to every
                       block, shifted by the block's first row; the kernel
                       skips the ids it does not own. A gather sums the
                       blocks' masked contributions, and the Gumbel top-k
                       merges each block's candidates, both on the
                       caller's device.
  ``QuantizedStore``   the int8 form over either, with per-block scales
                       and an error-feedback ring (a ring per row block
                       when sharded), and with ``wire`` the int8 payloads
                       of the cross-block gather and selection.

Per-process rows (``ScoreSharding.n_global``/``offset``, the reference's
CPU-cluster topology): this process's blocks cover only its row range of
an ``n_global``-row store, and the host legs (gather completion, the
pruning statistics, growth, checkpoints) finish across processes through
``distributed.hostcomm``'s exact collectives, bit for bit the one-process
store.

Set-level pruning reads the store on the host once an epoch:
``prune_snapshot`` copies the leaves to numpy (the store's only device →
host transfer, after a device sync) and ``prune_epoch`` runs
``core.pruning`` on that snapshot.

``grow(scores, n_new)`` (the online service's admission) extends a store
by ``n_new`` rows: the old rows bitwise, the new ones at the 1/n' prior,
never seen. It synchronises the device first, as the snapshot does:
pipelined ES leaves the last store writes on the scoring stream.

``leaf_state``/``load_leaf_state`` give a leaf as one tensor a field (the
blocks of a sharded leaf concatenated in row order, on the first block's
device) and back: that is the form ``ESEngine.state_dict`` and the
checkpointer see.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.score_update.ops import (fused_quant_score_update,
                                        fused_score_update,
                                        quant_grow_scales, quant_ring_slots)
from ..kernels.score_update.ref import q_gather_1d as _q_gather_1d
from .pruning import (PruneResult, PruneSnapshot, QuantPruneSnapshot,
                      prune_epoch_snapshot)
from .theory import es_weight_sequence, transfer_gain

Blocks = List[torch.Tensor]


@dataclasses.dataclass
class ESScores:
    """s: EMA of losses; w: sampling weights; seen: times scored. Each a
    (n,) tensor, or a sharded store's list of row blocks."""
    s: torch.Tensor      # (n,) f32
    w: torch.Tensor      # (n,) f32
    seen: torch.Tensor   # (n,) i32


@dataclasses.dataclass(frozen=True)
class ScoreSharding:
    """Row layout of the store: one contiguous row block per entry of
    ``devices`` (block d owns rows [d n/D, (d+1) n/D)); a device may hold
    several blocks.

    ``n_global``/``offset`` describe per-PROCESS ownership: when set, this
    process's blocks hold only rows ``[offset, offset + local_n)`` of an
    ``n_global``-row store.
    """
    devices: Tuple[torch.device, ...]
    n_global: Optional[int] = None   # logical rows (None: local == global)
    offset: int = 0                  # first global row of this process

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def shard_size(self, n: int) -> int:
        if n % self.n_shards != 0:
            raise ValueError(
                f"score store size {n} not divisible by the {self.n_shards}"
                f"-way shard over devices {[str(d) for d in self.devices]}")
        return n // self.n_shards


def init_scores(n: int, device="cuda",
                n_logical: Optional[int] = None) -> ESScores:
    """The 1/``n_logical`` prior (default 1/n) for every row, never
    seen."""
    prior = 1.0 / (n if n_logical is None else n_logical)
    return ESScores(s=torch.full((n,), prior, dtype=torch.float32,
                                 device=device),
                    w=torch.full((n,), prior, dtype=torch.float32,
                                 device=device),
                    seen=torch.zeros((n,), dtype=torch.int32, device=device))


def weights_from_prev(s_prev: torch.Tensor, losses: torch.Tensor,
                      beta1: float) -> torch.Tensor:
    """Eq. (3.1) first line from the pre-update s: the one weight rule."""
    return beta1 * s_prev + (1.0 - beta1) * losses.to(torch.float32)


def update_scores(scores: ESScores, sample_ids: torch.Tensor,
                  losses: torch.Tensor, beta1: float,
                  beta2: float) -> ESScores:
    """The scatter form of the update (``--no-fused-scores``), in place.

    Ids outside ``[0, n)`` are dropped. For duplicate ids the last write
    wins, computed from the ORIGINAL s (the reference's scatter); the
    fused kernel applies duplicates in sequence instead.
    """
    n = scores.s.shape[0]
    losses = losses.to(torch.float32)
    ids = sample_ids.long()
    keep = (ids >= 0) & (ids < n)
    ids, losses = ids[keep], losses[keep]
    s_prev = scores.s[ids]
    w_new = weights_from_prev(s_prev, losses, beta1)
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    scores.s[ids] = s_new
    scores.w[ids] = w_new
    scores.seen.index_put_((ids,), torch.ones_like(ids, dtype=torch.int32),
                           accumulate=True)
    return scores


def batch_weights(scores: ESScores, sample_ids: torch.Tensor,
                  losses: torch.Tensor, beta1: float,
                  beta2: float) -> torch.Tensor:
    """The w(t) of Eq. (3.1) for a meta-batch, without mutating state."""
    return weights_from_prev(scores.s[sample_ids.long()], losses, beta1)


def _settle(*tensors: torch.Tensor) -> None:
    """Wait for every stream's pending work on the tensors' devices (a
    no-op on the CPU)."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _check_grow(n_new: int) -> None:
    if n_new <= 0:
        raise ValueError(f"grow needs n_new > 0, got {n_new}")


def _host(*tensors: torch.Tensor) -> list:
    """Numpy copies of ``tensors``. On CUDA the devices are synchronised
    first: pipelined ES leaves the store's and the cadence's last writes
    on two streams, and a copy on the default stream alone could read the
    store before the scoring stream's update."""
    _settle(*tensors)
    return [t.to("cpu", copy=True).numpy() for t in tensors]


class _Store:
    """The protocol's shared side: ``prune_epoch`` over any store's
    ``prune_snapshot``, and the defaults of an unsharded store."""

    def prune_epoch(self, method: str, rng: np.random.Generator, scores, *,
                    prev_losses: Optional[np.ndarray] = None,
                    ratio: float = 0.2, ucb_c: float = 1.0,
                    ka_tau: float = 1.0
                    ) -> Tuple[PruneResult, np.ndarray]:
        """Set-level kept-set for the next epoch -> (PruneResult, s_full),
        ``s_full`` being the (n,) s-EMA snapshot the trainer keeps as
        ``prev_epoch_losses``."""
        snap = self.prune_snapshot(scores)
        res = prune_epoch_snapshot(method, rng, snap,
                                   prev_losses=prev_losses, ratio=ratio,
                                   ucb_c=ucb_c, ka_tau=ka_tau)
        return res, snap.full_losses()

    def validate(self, n: int) -> None:
        pass

    def checkpoint_partition(self) -> Optional[dict]:
        """Non-None when this process's leaves cover only a row range of
        the store (per-process rows): the checkpointer then writes and
        reads them as row blocks (``Checkpointer``)."""
        return None

    def leaf_state(self, leaf) -> Dict[str, torch.Tensor]:
        """The leaf as {field: tensor}."""
        return {f.name: getattr(leaf, f.name)
                for f in dataclasses.fields(leaf)}

    def load_leaf_state(self, tree: Dict[str, torch.Tensor], like):
        """The leaf ``leaf_state`` gave as ``tree``, shaped as ``like``."""
        return type(like)(**tree)


class ReplicatedStore(_Store):
    """Full (n,) float32 arrays on the one device."""

    def init_leaf(self, n: int, device="cuda") -> ESScores:
        return init_scores(n, device)

    def update(self, scores: ESScores, ids: torch.Tensor,
               losses: torch.Tensor, beta1: float, beta2: float, *,
               fused: bool = True) -> ESScores:
        """Eq. (3.1) in place; ``fused`` dispatches to the kernel, which
        drops ids outside [0, n) like the scatter path."""
        if fused:
            fused_score_update(scores.s, scores.w, scores.seen,
                               ids.to(torch.int32).contiguous(),
                               losses.to(torch.float32).contiguous(),
                               beta1=beta1, beta2=beta2)
            return scores
        return update_scores(scores, ids, losses, beta1, beta2)

    def gather(self, scores: ESScores, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = ids.long()
        return scores.s[ids], scores.w[ids]

    def select(self, weights: torch.Tensor, k: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        from .selection import gumbel_topk_select
        return gumbel_topk_select(weights, k, generator=generator,
                                  gumbel=gumbel)

    def prune_snapshot(self, scores: ESScores) -> PruneSnapshot:
        """The whole store as one host block."""
        w, s, seen = _host(scores.w, scores.s, scores.seen)
        return PruneSnapshot(weights=[w], losses=[s], seen=[seen],
                             offsets=np.asarray([0], np.int64),
                             n=int(scores.s.shape[0]))

    def grow(self, scores: ESScores, n_new: int
             ) -> Tuple["ReplicatedStore", ESScores]:
        """-> (store, a new leaf of n + ``n_new`` rows): the old rows
        bitwise, the new ones at the 1/n' prior with ``seen`` 0."""
        _check_grow(n_new)
        _settle(scores.s)
        n_tot = int(scores.s.shape[0]) + int(n_new)
        prior = torch.full((n_new,), 1.0 / n_tot, dtype=torch.float32,
                           device=scores.s.device)
        return self, ESScores(
            s=torch.cat([scores.s, prior]), w=torch.cat([scores.w, prior]),
            seen=torch.cat([scores.seen, torch.zeros(
                n_new, dtype=torch.int32, device=scores.seen.device)]))

    def checkpoint_spec(self) -> dict:
        """The backend's provenance in a checkpoint's manifest."""
        return {"kind": "replicated"}


# ---------------------------------------------------------------------------
# ShardedStore: row blocks over a device list (and over processes)
# ---------------------------------------------------------------------------

def _blocks_on(full: np.ndarray, devices: Sequence[torch.device]
               ) -> Blocks:
    """``full`` cut into len(devices) equal row blocks, each on its
    device."""
    size = len(full) // len(devices)
    return [torch.from_numpy(full[d * size:(d + 1) * size].copy()).to(dev)
            for d, dev in enumerate(devices)]


def _concat(blocks: Blocks) -> torch.Tensor:
    """The blocks in row order as one tensor on the first one's device."""
    dev = blocks[0].device
    return torch.cat([b.to(dev) for b in blocks])


def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order (one owner per element,
    zeros elsewhere: the sum is exact)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@dataclasses.dataclass(frozen=True)
class ShardedStore(_Store):
    """Row blocks over the ``ScoreSharding``'s devices.

    The per-block masked kernel dispatch, the masked-contribution gather
    and the candidate-merge Gumbel selection, behind the store protocol.
    With per-process rows (``sharding.n_global`` set) the gather and the
    host legs finish across processes through ``distributed.hostcomm``.
    """

    sharding: ScoreSharding = None

    @property
    def is_process_local(self) -> bool:
        """Per-process rows: this process's blocks cover only its range."""
        return self.sharding.n_global is not None

    @staticmethod
    def _comm():
        """The cross-process host collective of this run, or None outside
        a multi-process ``torch.distributed`` run."""
        from ..distributed.hostcomm import get_comm
        return get_comm()

    def _nproc_rank(self) -> Tuple[int, int]:
        comm = self._comm() if self.is_process_local else None
        return (comm.process_count, comm.process_index) if comm else (1, 0)

    def validate(self, n: int) -> None:
        local = n
        if self.is_process_local:
            nproc, _ = self._nproc_rank()
            if n % nproc != 0:
                raise ValueError(f"store size {n} not divisible by "
                                 f"{nproc} processes")
            local = n // nproc
        self.sharding.shard_size(local)

    def _rows0(self, shard: int) -> List[int]:
        """Each block's first global row."""
        return [self.sharding.offset + d * shard
                for d in range(self.sharding.n_shards)]

    def init_leaf(self, n: int, device=None) -> ESScores:
        """One block a device of the sharding, at the 1/n prior (``device``
        is the replicated store's argument; the blocks have theirs)."""
        self.validate(n)
        ss = self.sharding
        if self.is_process_local and n != ss.n_global:
            raise ValueError(f"init_leaf({n}) of a store of "
                             f"{ss.n_global} rows")
        nproc, _ = self._nproc_rank()
        shard = ss.shard_size(n // nproc)
        leaves = [init_scores(shard, dev, n_logical=n) for dev in ss.devices]
        return ESScores(s=[x.s for x in leaves], w=[x.w for x in leaves],
                        seen=[x.seen for x in leaves])

    # -- device ops ------------------------------------------------------
    def update(self, scores: ESScores, ids: torch.Tensor,
               losses: torch.Tensor, beta1: float, beta2: float, *,
               fused: bool = True) -> ESScores:
        """Eq. (3.1) in place, block by block: each block takes the ids
        shifted by its first row, on its device, and drops those outside
        [0, shard) (another block's rows): the kernel skips them, the
        scatter form masks them."""
        shard = scores.s[0].shape[0]
        ids = ids.to(torch.int32)
        losses = losses.to(torch.float32)
        for d, row0 in enumerate(self._rows0(shard)):
            dev = scores.s[d].device
            local = (ids.to(dev) - row0).contiguous()
            ls = losses.to(dev).contiguous()
            if fused:
                fused_score_update(scores.s[d], scores.w[d], scores.seen[d],
                                   local, ls, beta1=beta1, beta2=beta2)
            else:
                update_scores(ESScores(scores.s[d], scores.w[d],
                                       scores.seen[d]), local, ls, beta1,
                              beta2)
        return scores

    def _contributions(self, ids: torch.Tensor, devices, shard: int,
                       take) -> List[List[torch.Tensor]]:
        """Each block's share of a gather of the global ``ids``, on the
        ids' device: ``take(d, pos, mask, gids)`` reads block d's fields at
        the local positions ``pos`` (an id the block does not own, False
        in ``mask``, reads row 0) and the rows it does not own are zeroed.
        -> for each field, its D parts in block order."""
        out = ids.device
        parts = []
        for d, row0 in enumerate(self._rows0(shard)):
            dev = devices[d]
            gids = ids.to(dev).long()
            local = gids - row0
            mask = (local >= 0) & (local < shard)
            pos = torch.where(mask, local, torch.zeros_like(local))
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            parts.append([torch.where(mask, v, zero).to(out)
                          for v in take(d, pos, mask, gids)])
        return [list(f) for f in zip(*parts)]

    def _complete(self, parts: List[torch.Tensor], wire: bool = False
                  ) -> torch.Tensor:
        """The sum of one field's block contributions, exact in block
        order or through the int8 wire (``compressed_psum_sum``); with
        per-process rows the host collective completes it across
        processes (exactly, or ``allreduce_sum_compressed`` on the
        wire). Every row has one owner, so the exact sum routes."""
        if wire:
            from ..distributed.compression import compressed_psum_sum
            v = compressed_psum_sum(torch.stack(parts))
        else:
            v = _ordered_sum(parts)
        comm = self._comm() if self.is_process_local else None
        if comm is not None:
            red = comm.allreduce_sum_compressed if wire \
                else comm.allreduce_sum
            v = torch.from_numpy(red(_host(v)[0])).to(v.device)
        return v

    def gather(self, scores: ESScores, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s[ids], w[ids]) on ``ids``' device: the blocks' masked
        contributions summed in block order, completed across processes
        with per-process rows."""
        s_p, w_p = self._contributions(
            ids, [b.device for b in scores.s], scores.s[0].shape[0],
            lambda d, pos, *_: (scores.s[d][pos], scores.w[d][pos]))
        return self._complete(s_p), self._complete(w_p)

    def _candidates(self, weights: torch.Tensor, k: int,
                    generator: Optional[torch.Generator],
                    gumbel: Optional[torch.Tensor],
                    max_slice: Optional[int] = None) -> Optional[list]:
        """Each block's top min(k, B/D) Gumbel keys over its slice of the
        (B,) weights, by position: [(keys, positions in the slice, the
        slice's first position)] on the blocks' devices, the noise drawn
        once over all B as the replicated store draws it. None where the
        replicated form is the result: per-process rows (the weights are
        complete on every process), B not divisible by D, or a slice
        longer than ``max_slice``."""
        from .selection import _EPS, sample_gumbel, top_k
        B = weights.shape[0]
        D = self.sharding.n_shards
        if self.is_process_local or B % D != 0 or (
                max_slice is not None and B // D > max_slice):
            return None
        if gumbel is None:
            gumbel = sample_gumbel(weights.shape, generator, weights.device)
        gumbel = gumbel.to(weights.device)
        n_local = B // D
        m = min(k, n_local)
        out = []
        for d, dev in enumerate(self.sharding.devices):
            lo = d * n_local
            logw = torch.log(torch.clamp(
                weights[lo:lo + n_local].to(dev).float(), min=_EPS))
            kv, ki = top_k(logw + gumbel[lo:lo + n_local].to(dev), m)
            out.append((kv, ki, lo))
        return out

    def select(self, weights: torch.Tensor, k: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gumbel top-k over (B,) weights split into D slices by position:
        the merge takes the top k of the blocks' candidates. The global
        top-k holds at most k entries of one slice and the keys are the
        replicated ones, so the result is the replicated selection, ties
        going to the lower position (stable sorts, as ``jax.lax.top_k``);
        where ``_candidates`` gives none, it is the replicated form."""
        from .selection import gumbel_topk_select, top_k
        cands = self._candidates(weights, k, generator, gumbel)
        if cands is None:
            return gumbel_topk_select(weights, k, generator=generator,
                                      gumbel=gumbel)
        out = weights.device
        _, sel = top_k(torch.cat([kv.to(out) for kv, _, _ in cands]), k)
        pos = torch.cat([(ki + lo).to(out) for _, ki, lo in cands])
        return pos[sel].to(torch.int32)

    # -- host ops --------------------------------------------------------
    def _covers(self, n_local: int, n: int):
        """The comm the pruning statistics reduce over, or None when this
        process holds every row; a partial view without one raises."""
        comm = self._comm() if self.is_process_local else None
        if comm is None and n_local != n:
            raise AssertionError(
                f"prune_snapshot: local blocks cover {n_local} of {n} rows "
                "but no host collective is available (torch.distributed "
                "not initialised?)")
        return comm

    def prune_snapshot(self, scores: ESScores) -> PruneSnapshot:
        """This process's blocks, with the comm that completes the global
        statistics when rows are process-owned."""
        D = len(scores.s)
        host = _host(*scores.w, *scores.s, *scores.seen)
        shard = scores.s[0].shape[0]
        n = self.sharding.n_global if self.is_process_local else D * shard
        return PruneSnapshot(
            weights=host[:D], losses=host[D:2 * D], seen=host[2 * D:],
            offsets=np.asarray(self._rows0(shard), np.int64), n=int(n),
            comm=self._covers(D * shard, n))

    def _assemble_global(self, blocks: Blocks) -> np.ndarray:
        """The FULL logical array on the host, the same on every process:
        the blocks in row order, then (per-process rows) every process's
        rows in rank order."""
        local = np.concatenate(_host(*blocks))
        comm = self._comm() if self.is_process_local else None
        if comm is not None:
            return np.concatenate(comm.allgather(local))
        return local

    def grow(self, scores: ESScores, n_new: int
             ) -> Tuple["ShardedStore", ESScores]:
        """Re-slice the grown row space over the same devices.

        Global row ids are stable (new rows append at the end), but every
        block boundary moves: the old rows are assembled on the host, the
        1/n' prior appended, and this process's new range cut back into
        blocks. With per-process rows the returned store is a new one (its
        offset moved); the caller swaps both."""
        _check_grow(n_new)
        new_store, _, n_tot, rank, local_n = self._regrow(
            sum(int(b.shape[0]) for b in scores.s), int(n_new))
        prior = np.full((n_new,), np.float32(1.0 / n_tot), np.float32)

        def regrow(blocks, tail):
            return self._deal(np.concatenate(
                [self._assemble_global(blocks), tail]), rank, local_n)

        return new_store, ESScores(
            s=regrow(scores.s, prior), w=regrow(scores.w, prior),
            seen=regrow(scores.seen, np.zeros((n_new,), np.int32)))

    def _regrow(self, rows_local: int, n_new: int
                ) -> Tuple["ShardedStore", int, int, int, int]:
        """The layout of the row space grown by ``n_new``: (the store over
        it, the old and the new global row counts, this process's rank,
        its rows). With per-process rows the store is a new one, its
        offset moved."""
        ss = self.sharding
        n_old = int(ss.n_global) if self.is_process_local else rows_local
        n_tot = n_old + n_new
        nproc, rank = self._nproc_rank()
        if self.is_process_local and n_tot % nproc != 0:
            raise ValueError(f"grown store size {n_tot} not divisible by "
                             f"{nproc} processes")
        local_n = n_tot // nproc
        new = self
        if self.is_process_local:
            new = dataclasses.replace(self, sharding=dataclasses.replace(
                ss, n_global=n_tot, offset=rank * local_n))
        new.validate(n_tot)
        return new, n_old, n_tot, rank, local_n

    def _deal(self, full: np.ndarray, rank: int, rows: int) -> Blocks:
        """Process ``rank``'s ``rows`` of a global host array (processes
        in rank order), cut into this store's blocks on their devices."""
        return _blocks_on(full[rank * rows:(rank + 1) * rows],
                          self.sharding.devices)

    # -- placement plumbing ----------------------------------------------
    def checkpoint_spec(self) -> dict:
        comm = self._comm()
        return {"kind": "sharded",
                "devices": [str(d) for d in self.sharding.devices],
                "n_global": self.sharding.n_global,
                "offset": int(self.sharding.offset),
                "process_count": comm.process_count if comm else 1}

    def checkpoint_partition(self) -> Optional[dict]:
        if not self.is_process_local:
            return None        # the blocks save as whole (n,) leaves
        return {"prefixes": ("scores/",),
                "offset": int(self.sharding.offset),
                "n_global": int(self.sharding.n_global),
                "comm": self._comm()}

    def leaf_state(self, leaf) -> Dict[str, torch.Tensor]:
        """Each field's blocks concatenated in row order (this process's
        rows), on the first block's device."""
        return {f.name: _concat(getattr(leaf, f.name))
                for f in dataclasses.fields(leaf)}

    def load_leaf_state(self, tree: Dict[str, torch.Tensor], like):
        """Each field cut back into ``like``'s blocks, on their devices."""
        out = {}
        for f in dataclasses.fields(like):
            full, lo, blocks = tree[f.name], 0, []
            for b in getattr(like, f.name):
                blocks.append(full[lo:lo + b.shape[0]].to(
                    device=b.device, dtype=b.dtype, copy=True))
                lo += b.shape[0]
            out[f.name] = blocks
        return type(like)(**out)


# ---------------------------------------------------------------------------
# QuantizedStore: int8 score state with per-block scales + error feedback
# ---------------------------------------------------------------------------

_QMAX = 127.0
_SCALE_FLOOR = 1e-12


@dataclasses.dataclass
class QuantizedScores:
    """Int8 form of the score triple: codes on a per-block grid (row r uses
    ``*_scale[r // block]``), ``seen_q`` saturating at 127, grow-only f32
    scales, and the error-feedback ring of the most recently updated rows
    (``err_rows`` global ids, -1 empty; ``err_seq`` recency stamps, 0
    empty; ``err_s``/``err_w`` the residuals). A gather returns
    ``code * scale + newest residual``: exact for a row still in the ring,
    within scale/2 after eviction. Sharded: each field is a list, one
    block's rows, scales and ring a device."""
    s_q: torch.Tensor       # (n,) int8
    w_q: torch.Tensor       # (n,) int8
    seen_q: torch.Tensor    # (n,) int8
    s_scale: torch.Tensor   # (n_blocks,) f32
    w_scale: torch.Tensor   # (n_blocks,) f32
    err_rows: torch.Tensor  # (R,) int32
    err_seq: torch.Tensor   # (R,) int32
    err_s: torch.Tensor     # (R,) f32
    err_w: torch.Tensor     # (R,) f32


Scores = Union[ESScores, QuantizedScores]


def _q_init_leaf(rows: int, n_blocks: int, ring: int, n_logical: int,
                 device="cuda") -> QuantizedScores:
    """The 1/``n_logical`` prior as code 127 on a (1/n_logical)/127 grid,
    an empty ring."""
    scale0 = (1.0 / n_logical) / _QMAX

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return QuantizedScores(
        s_q=full((rows,), 127, torch.int8), w_q=full((rows,), 127, torch.int8),
        seen_q=full((rows,), 0, torch.int8),
        s_scale=full((n_blocks,), scale0, torch.float32),
        w_scale=full((n_blocks,), scale0, torch.float32),
        err_rows=full((ring,), -1, torch.int32),
        err_seq=full((ring,), 0, torch.int32),
        err_s=full((ring,), 0.0, torch.float32),
        err_w=full((ring,), 0.0, torch.float32))


def _q_block(qs: QuantizedScores, d: int) -> QuantizedScores:
    """Block ``d`` of a sharded leaf as a leaf of its own."""
    return QuantizedScores(**{f.name: getattr(qs, f.name)[d]
                              for f in dataclasses.fields(qs)})


def _q_apply_fixed(qs: QuantizedScores, pos: torch.Tensor,
                   mask: torch.Tensor, gids: torch.Tensor,
                   losses: torch.Tensor, beta1: float, beta2: float,
                   block: int, slots: torch.Tensor,
                   seqs: torch.Tensor) -> QuantizedScores:
    """Fixed-scale dequant -> Eq. (3.1) -> requant + ring write in scatter
    form (``--no-fused-scores``), in place. Every id reads the pre-batch
    state; for duplicate ids the winning write is unspecified on CUDA, as
    in the reference's scatter. Masked entries are dropped."""
    n, R = qs.s_q.shape[0], qs.err_rows.shape[0]
    pos = pos.long()
    blk = pos // block
    ssc, wsc = qs.s_scale[blk], qs.w_scale[blk]
    s_prev = _q_gather_1d(qs.s_q, qs.s_scale, block, qs.err_rows,
                          qs.err_seq, qs.err_s, pos, gids)
    w_new = weights_from_prev(s_prev, losses, beta1)
    s_new = beta2 * s_prev + (1.0 - beta2) * losses
    q_s = torch.clamp(torch.round(s_new / ssc), -_QMAX, _QMAX)
    q_w = torch.clamp(torch.round(w_new / wsc), -_QMAX, _QMAX)
    e_s = s_new - q_s * ssc
    e_w = w_new - q_w * wsc
    rows = pos[mask]
    qs.s_q[rows] = q_s[mask].to(torch.int8)
    qs.w_q[rows] = q_w[mask].to(torch.int8)
    adds = torch.bincount(rows, minlength=n).to(torch.int32)
    qs.seen_q.copy_(torch.clamp(qs.seen_q.to(torch.int32) + adds,
                                max=127).to(torch.int8))
    slot = slots.long()
    wr = mask & (slot >= 0) & (slot < R)
    at = slot[wr]
    qs.err_rows[at] = gids[wr].to(torch.int32)
    qs.err_seq[at] = seqs[wr].to(torch.int32)
    qs.err_s[at] = e_s[wr]
    qs.err_w[at] = e_w[wr]
    return qs


def _q_update_local(qs: QuantizedScores, local_ids: torch.Tensor,
                    gids: torch.Tensor, losses: torch.Tensor, beta1: float,
                    beta2: float, block: int,
                    use_kernel: bool) -> QuantizedScores:
    """One full update, in place: grow the scales (and re-code the blocks
    that grew), assign ring slots, then apply through the kernel
    (sequential) or the scatter form. Rows outside [0, n) are masked. On a
    CUDA store the grow, the slots and the kernel apply are one launch
    each and nothing here is O(n); the scatter form stays PyTorch."""
    n = qs.s_q.shape[0]
    ids = local_ids.to(torch.int32).contiguous()
    gids = gids.to(torch.int32).contiguous()
    losses = losses.to(torch.float32).contiguous()
    quant_grow_scales(qs.s_q, qs.w_q, qs.s_scale, qs.w_scale, qs.err_rows,
                      qs.err_seq, qs.err_s, ids, gids, losses, beta1=beta1,
                      beta2=beta2, block=block)
    slots, seqs = quant_ring_slots(qs.err_seq, ids, n)
    if use_kernel:
        # out-of-range ids are skipped by the kernel; gids are read only
        # for in-range ones
        fused_quant_score_update(
            qs.s_q, qs.w_q, qs.seen_q, qs.s_scale, qs.w_scale, qs.err_rows,
            qs.err_seq, qs.err_s, qs.err_w, ids, gids, losses, slots, seqs,
            beta1=beta1, beta2=beta2, block=block)
        return qs
    mask = (ids >= 0) & (ids < n)
    pos = torch.where(mask, ids, torch.zeros_like(ids))
    mgids = torch.where(mask, gids, torch.full_like(gids, -1))
    return _q_apply_fixed(qs, pos, mask, mgids, losses, beta1, beta2, block,
                          slots, seqs)


def _dequant_blocks_host(q_blocks, scale_blocks, block: int, ring,
                         offsets) -> list:
    """Host dequant of int8 row blocks, then the ring's residuals applied
    in recency order (``err_seq``; 0 = empty slot). Rows outside the
    blocks are ignored. The reference's host arithmetic, step for step
    (``repro/core/scores.py:1047-1071``)."""
    rows_all, seq_all, val_all = ring
    order = np.argsort(seq_all, kind="stable")
    rows_o, seq_o, val_o = (rows_all[order], seq_all[order],
                            val_all[order])
    live = seq_o > 0
    rows_o, val_o = rows_o[live], val_o[live]
    out = []
    for q, sc, off in zip(q_blocks, scale_blocks, offsets):
        L = len(q)
        nb = len(sc)
        blk = -(-L // nb) if nb else block
        pad = nb * blk - L
        deq = (np.pad(q.astype(np.float32), (0, pad)).reshape(nb, blk)
               * sc[:, None]).reshape(-1)[:L]
        here = (rows_o >= off) & (rows_o < off + L)
        for r, v in zip(rows_o[here], val_o[here]):
            deq[r - off] = deq[r - off] + v
        out.append(deq)
    return out


def _new_row_codes(n_tot: int, new_blk: np.ndarray,
                   scales: np.ndarray) -> np.ndarray:
    """Int8 codes of the 1/n' prior of appended rows on their blocks'
    scales: code 127 on a fresh block, the nearest code in an old partial
    tail block (the reference's numpy arithmetic)."""
    q = np.round((1.0 / n_tot) / scales[new_blk])
    return np.clip(q, -_QMAX, _QMAX).astype(np.int8)


@dataclasses.dataclass(frozen=True)
class QuantizedStore(_Store):
    """Int8 decorator over a replicated or sharded backend: the same store
    protocol with ~4x smaller state (3 int8 rows, per-``block`` scales and
    a ``residual_rows`` error-feedback ring instead of 12 B/row).

    Placement is ``inner``'s (row routing, devices, per-process rows); the
    int8 leaf layout, the grow-only scales and the ring are this class's.
    Sharded, each row block holds its own scales and its share of the
    ring. ``wire`` ships the cross-block gather and the candidate merge as
    int8 payloads (``distributed.compression``); off, the sharded store is
    bitwise the replicated one while no live residual is evicted (the
    ring is per block, so which rows fall back to the grid once it
    overflows differs between layouts; both stay within scale/2).
    """

    inner: Union[ReplicatedStore, ShardedStore] = dataclasses.field(
        default_factory=ReplicatedStore)
    block: int = 1024           # rows per scale (clamped to the shard)
    residual_rows: int = 1024   # error-feedback ring size (global)
    wire: bool = False

    @property
    def _sharded(self) -> bool:
        return isinstance(self.inner, ShardedStore)

    @property
    def is_process_local(self) -> bool:
        return self._sharded and self.inner.is_process_local

    # -- layout ----------------------------------------------------------
    def _nproc(self) -> int:
        return self.inner._nproc_rank()[0] if self._sharded else 1

    def _rows_local(self, n: int) -> int:
        return n // self._nproc() if self.is_process_local else n

    def _layout(self, rows_local: int) -> Tuple[int, int, int]:
        """(block, scales, ring rows) of THIS process's leaves; sharded,
        a ring of ceil(R / (P D)) rows a block."""
        if self._sharded:
            ss = self.inner.sharding
            shard = ss.shard_size(rows_local)
            blk = min(self.block, shard)
            if shard % blk != 0:
                raise ValueError(
                    f"quant block {self.block} does not divide the "
                    f"{shard}-row shard; pick a divisor")
            per_shard = -(-self.residual_rows // (self._nproc()
                                                  * ss.n_shards))
            return blk, ss.n_shards * (shard // blk), \
                max(1, per_shard) * ss.n_shards
        blk = min(self.block, rows_local)
        return blk, -(-rows_local // blk), self.residual_rows

    def _rows(self, qs: QuantizedScores) -> int:
        return sum(int(b.shape[0]) for b in qs.s_q) if self._sharded \
            else int(qs.s_q.shape[0])

    def validate(self, n: int) -> None:
        self.inner.validate(n)
        self._layout(self._rows_local(n))

    def init_leaf(self, n: int, device="cuda") -> QuantizedScores:
        self.validate(n)
        rows = self._rows_local(n)
        blk, nb, ring = self._layout(rows)
        if not self._sharded:
            return _q_init_leaf(rows, nb, ring, n, device)
        devs = self.inner.sharding.devices
        D = len(devs)
        leaves = [_q_init_leaf(rows // D, nb // D, ring // D, n, dev)
                  for dev in devs]
        return QuantizedScores(**{f.name: [getattr(x, f.name) for x in leaves]
                                  for f in dataclasses.fields(QuantizedScores)})

    # -- device ops ------------------------------------------------------
    def update(self, qs: QuantizedScores, ids: torch.Tensor,
               losses: torch.Tensor, beta1: float, beta2: float, *,
               fused: bool = True) -> QuantizedScores:
        """In place; ``fused`` dispatches to the quantized kernels, else
        the scatter form. Sharded: block by block, on each block's device,
        its local rows shifted by its first row and the global ids keyed
        in its ring. Ids outside a block's rows are dropped there."""
        blk = self._layout(self._rows(qs))[0]
        if not self._sharded:
            return _q_update_local(qs, ids, ids, losses, beta1, beta2, blk,
                                   fused)
        ids = ids.to(torch.int32)
        shard = qs.s_q[0].shape[0]
        for d, row0 in enumerate(self.inner._rows0(shard)):
            dev = qs.s_q[d].device
            gids = ids.to(dev)
            _q_update_local(_q_block(qs, d), gids - row0, gids,
                            losses.to(dev), beta1, beta2, blk, fused)
        return qs

    def gather(self, qs: QuantizedScores, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s[ids], w[ids]) dequantized with the newest residual, on
        ``ids``' device. Sharded: the blocks' masked contributions summed
        exactly, or through the int8 wire (``compressed_psum_sum``, then
        ``allreduce_sum_compressed`` across processes)."""
        blk = self._layout(self._rows(qs))[0]
        if not self._sharded:
            n = qs.s_q.shape[0]
            pos = torch.clamp(ids.long(), 0, n - 1)
            s = _q_gather_1d(qs.s_q, qs.s_scale, blk, qs.err_rows,
                             qs.err_seq, qs.err_s, pos, ids)
            w = _q_gather_1d(qs.w_q, qs.w_scale, blk, qs.err_rows,
                             qs.err_seq, qs.err_w, pos, ids)
            return s, w
        def take(d, pos, mask, gids):
            # a foreign id keys no residual of this block's ring
            mg = torch.where(mask, gids, torch.full_like(gids, -1))
            return tuple(_q_gather_1d(
                getattr(qs, q)[d], getattr(qs, sc)[d], blk, qs.err_rows[d],
                qs.err_seq[d], getattr(qs, e)[d], pos, mg)
                for q, sc, e in (("s_q", "s_scale", "err_s"),
                                 ("w_q", "w_scale", "err_w")))

        s_p, w_p = self.inner._contributions(
            ids, [b.device for b in qs.s_q], qs.s_q[0].shape[0], take)
        return (self.inner._complete(s_p, self.wire),
                self.inner._complete(w_p, self.wire))

    def select(self, weights: torch.Tensor, k: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.wire or not self._sharded:
            return self.inner.select(weights, k, generator=generator,
                                     gumbel=gumbel)
        return self._select_wire(weights, k, generator=generator,
                                 gumbel=gumbel)

    def _select_wire(self, weights: torch.Tensor, k: int, *,
                     generator: Optional[torch.Generator] = None,
                     gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Candidate-merge Gumbel top-k with an int8 wire: each block
        ships its top-m keys affine-quantized to int8 (offset = its top
        key, scale = its candidates' span / 127) and int16 positions in
        its slice, 3 B a candidate and 8 B a block instead of 8 B a
        candidate. The merge ranks the dequantized keys, so it may differ
        from the exact one within one key-grid step."""
        from .selection import gumbel_topk_select, top_k
        cands = self.inner._candidates(weights, k, generator, gumbel,
                                       max_slice=32767)
        if cands is None:
            return gumbel_topk_select(weights, k, generator=generator,
                                      gumbel=gumbel)
        m = cands[0][0].shape[0]
        out = weights.device
        q_all, id_all, off_all, sc_all = [], [], [], []
        for kv, ki, _ in cands:
            off = kv[0]
            sc = torch.clamp((off - kv[m - 1]) / torch.full(
                (), _QMAX, device=kv.device), min=_SCALE_FLOOR)
            q = torch.clamp(torch.round((kv - off) / sc), -_QMAX, 0.0
                            ).to(torch.int8)
            q_all.append(q.to(out))
            id_all.append(ki.to(torch.int16).to(out))
            off_all.append(off.reshape(1).to(out))
            sc_all.append(sc.reshape(1).to(out))
        src = torch.arange(len(cands) * m, dtype=torch.int64, device=out) // m
        keys = torch.cat(off_all)[src] + torch.cat(q_all).to(
            torch.float32) * torch.cat(sc_all)[src]
        _, sel = top_k(keys, k)
        n_local = weights.shape[0] // len(cands)
        gids = torch.cat(id_all).to(torch.int32) + (src * n_local).to(
            torch.int32)
        return gids[sel]

    # -- host ops --------------------------------------------------------
    def prune_snapshot(self, qs: QuantizedScores) -> QuantPruneSnapshot:
        """Residual-corrected dequants of ``s`` and ``w`` by row block,
        with the raw codes and scales beside them (and, for process-owned
        rows, the comm that completes the statistics)."""
        n_local = self._rows(qs)
        blk = self._layout(n_local)[0]
        names = [f.name for f in dataclasses.fields(QuantizedScores)]
        if not self._sharded:
            h = dict(zip(names, _host(*(getattr(qs, f) for f in names))))
            h = {k: [v] for k, v in h.items()}
            offs, n, comm = [0], n_local, None
        else:
            D = len(qs.s_q)
            flat = _host(*(t for f in names for t in getattr(qs, f)))
            h = {f: flat[i * D:(i + 1) * D] for i, f in enumerate(names)}
            offs = self.inner._rows0(qs.s_q[0].shape[0])
            n = self.inner.sharding.n_global if self.is_process_local \
                else n_local
            comm = self.inner._covers(n_local, n)
        rows, seq = np.concatenate(h["err_rows"]), np.concatenate(h["err_seq"])
        losses = _dequant_blocks_host(
            h["s_q"], h["s_scale"], blk,
            (rows, seq, np.concatenate(h["err_s"])), offs)
        weights = _dequant_blocks_host(
            h["w_q"], h["w_scale"], blk,
            (rows, seq, np.concatenate(h["err_w"])), offs)
        return QuantPruneSnapshot(
            weights=weights, losses=losses,
            seen=[b.astype(np.int32) for b in h["seen_q"]],
            offsets=np.asarray(offs, np.int64), n=int(n), comm=comm,
            q_losses=h["s_q"], q_scales=h["s_scale"], q_block=blk,
            wire=self.wire and self._sharded)

    def grow(self, qs: QuantizedScores, n_new: int
             ) -> Tuple["QuantizedStore", QuantizedScores]:
        """Grow codes and per-block scales together. Old blocks keep codes
        and scales bitwise; new blocks start on the fresh (1/n')/127
        grid, and a new row in the old partial tail block takes its
        nearest code on that block's scale. A block size that would
        change across the grow (``block`` above the old row count or
        shard) raises: every old row would re-code. Replicated, the ring
        keeps its rows (their global ids do not move); sharded, see
        ``_grow_sharded``."""
        _check_grow(n_new)
        if self._sharded:
            return self._grow_sharded(qs, int(n_new))
        _settle(qs.s_q)
        n_old = int(qs.s_q.shape[0])
        n_tot = n_old + int(n_new)
        blk, blk2 = self._layout(n_old)[0], self._layout(n_tot)[0]
        if blk2 != blk:
            raise ValueError(
                f"quant block changes across grow ({blk} -> {blk2}): "
                f"construct the store with block <= the pre-grow row "
                f"count so block boundaries are stable")
        nb_old, nb_new = -(-n_old // blk), -(-n_tot // blk)
        dev = qs.s_q.device
        scale0 = torch.full((nb_new - nb_old,),
                            float(np.float32((1.0 / n_tot) / _QMAX)),
                            dtype=torch.float32, device=dev)
        s_scale = torch.cat([qs.s_scale, scale0])
        w_scale = torch.cat([qs.w_scale, scale0])
        # the new rows' codes from the scales of the blocks they land in
        # (the old tail and new ones)
        lo = n_old // blk
        new_blk = np.arange(n_old, n_tot, dtype=np.int64) // blk - lo

        def codes(scales: torch.Tensor) -> torch.Tensor:
            sc = scales[lo:].cpu().numpy()
            return torch.from_numpy(_new_row_codes(n_tot, new_blk, sc)).to(
                dev)

        return self, dataclasses.replace(
            qs, s_q=torch.cat([qs.s_q, codes(s_scale)]),
            w_q=torch.cat([qs.w_q, codes(w_scale)]),
            seen_q=torch.cat([qs.seen_q, torch.zeros(
                n_new, dtype=torch.int8, device=dev)]),
            s_scale=s_scale, w_scale=w_scale)

    def _grow_sharded(self, qs: QuantizedScores, n_new: int
                      ) -> Tuple["QuantizedStore", QuantizedScores]:
        """Assemble the global codes, scales and ring on the host (rows in
        row order, scales in global block order, the ring in global block
        order), append, re-deal the ring, and cut this process's new
        ranges back into blocks. The ring keeps the newest entry of each
        live row and deals it to the block that owns the row now, newest
        first; a block's ring that overflows drops its oldest."""
        inner: ShardedStore = self.inner
        ss = inner.sharding
        rows_old = self._rows(qs)
        blk, _, ring = self._layout(rows_old)
        new_inner, n_old, n_tot, rank, local_n = inner._regrow(rows_old,
                                                               n_new)
        new_self = dataclasses.replace(self, inner=new_inner)
        blk2, _, ring2 = new_self._layout(local_n)
        if blk2 != blk:
            raise ValueError(
                f"quant block changes across grow ({blk} -> {blk2}): "
                f"construct the store with block <= the pre-grow shard "
                f"so block boundaries are stable")
        assert ring2 == ring, (ring, ring2)    # processes and blocks kept

        g = {f.name: inner._assemble_global(getattr(qs, f.name))
             for f in dataclasses.fields(qs)}
        scale0 = np.float32((1.0 / n_tot) / _QMAX)
        nb_g_new = n_tot // blk
        for f in ("s_scale", "w_scale"):
            g[f] = np.concatenate([g[f], np.full(
                (nb_g_new - len(g[f]),), scale0, np.float32)])
        new_blk = np.arange(n_old, n_tot, dtype=np.int64) // blk
        g["s_q"] = np.concatenate(
            [g["s_q"], _new_row_codes(n_tot, new_blk, g["s_scale"])])
        g["w_q"] = np.concatenate(
            [g["w_q"], _new_row_codes(n_tot, new_blk, g["w_scale"])])
        g["seen_q"] = np.concatenate([g["seen_q"],
                                      np.zeros((n_new,), np.int8)])

        # re-deal the ring: the newest entry of each live row, to its owner
        er_g, et_g = g["err_rows"], g["err_seq"]
        shard_new = local_n // ss.n_shards
        per_shard = ring // ss.n_shards
        order = np.argsort(-et_g, kind="stable")   # newest first
        live = et_g[order] > 0
        rows_o, seq_o = er_g[order][live], et_g[order][live]
        es_o, ew_o = g["err_s"][order][live], g["err_w"][order][live]
        _, first = np.unique(rows_o, return_index=True)
        keep = np.sort(first)
        rows_o, seq_o, es_o, ew_o = (rows_o[keep], seq_o[keep], es_o[keep],
                                     ew_o[keep])
        G = self._nproc() * ss.n_shards
        er_n = np.full((G * per_shard,), -1, np.int32)
        et_n = np.zeros((G * per_shard,), np.int32)
        es_n = np.zeros((G * per_shard,), np.float32)
        ew_n = np.zeros((G * per_shard,), np.float32)
        owner = rows_o // shard_new
        for b in range(G):
            here = np.nonzero(owner == b)[0][:per_shard]   # newest first
            lo = b * per_shard
            er_n[lo:lo + len(here)] = rows_o[here]
            et_n[lo:lo + len(here)] = seq_o[here]
            es_n[lo:lo + len(here)] = es_o[here]
            ew_n[lo:lo + len(here)] = ew_o[here]
        g.update(err_rows=er_n, err_seq=et_n, err_s=es_n, err_w=ew_n)

        nb_local = local_n // blk
        span = {"s_scale": nb_local, "w_scale": nb_local, "err_rows": ring,
                "err_seq": ring, "err_s": ring, "err_w": ring}
        return new_self, QuantizedScores(**{
            f: inner._deal(full, rank, span.get(f, local_n))
            for f, full in g.items()})

    # -- placement plumbing ----------------------------------------------
    def checkpoint_spec(self) -> dict:
        return {"kind": "quantized", "block": int(self.block),
                "residual_rows": int(self.residual_rows),
                "wire": bool(self.wire),
                "inner": self.inner.checkpoint_spec()}

    def checkpoint_partition(self) -> Optional[dict]:
        """The inner store's, by leaf: rows, scales and ring slots split
        evenly across processes, so each leaf's block offset is rank x
        its local length."""
        part = self.inner.checkpoint_partition()
        if part is None:
            return None
        comm = part["comm"]
        return dict(part, per_leaf=True,
                    rank=comm.process_index if comm else 0)

    def leaf_state(self, leaf) -> Dict[str, torch.Tensor]:
        return self.inner.leaf_state(leaf)

    def load_leaf_state(self, tree: Dict[str, torch.Tensor], like):
        return self.inner.load_leaf_state(tree, like)


Store = Union[ReplicatedStore, ShardedStore, QuantizedStore]


def make_store(sharding: Optional[ScoreSharding] = None, *,
               quantize: bool = False, block: int = 1024,
               residual_rows: int = 1024, wire: bool = False) -> Store:
    """The backend for a row layout: ``ShardedStore`` over a
    ``ScoreSharding``, else the replicated store; ``quantize`` wraps
    either in the int8 ``QuantizedStore`` (``block`` rows a scale,
    ``residual_rows`` ring slots, ``wire`` for int8 cross-block
    payloads)."""
    inner = ReplicatedStore() if sharding is None else ShardedStore(sharding)
    if not quantize:
        return inner
    return QuantizedStore(inner, block=block, residual_rows=residual_rows,
                          wire=wire)


# ---------------------------------------------------------------------------
# Explicit (unrolled) forms: for tests and theory checks only
# ---------------------------------------------------------------------------

def explicit_weights(loss_history: torch.Tensor, beta1: float, beta2: float,
                     s0: float) -> torch.Tensor:
    """Unrolled Eq. (3.1): loss_history (T,) -> w(T) exactly: the last w
    of ``theory.es_weight_sequence`` (float64), in the history's dtype;
    ``s0`` for an empty history.

    w(t) = beta1 * s(t-1) + (1-beta1) * l(t) with
    s(t) = beta2^t s0 + (1-beta2) sum_k beta2^{t-k} l(k).
    """
    if loss_history.shape[0] == 0:
        return torch.tensor(s0).to(loss_history)
    w, _ = es_weight_sequence(loss_history, beta1, beta2, s0)
    return w[-1].to(loss_history)


def expansion_weights(loss_history: torch.Tensor, beta1: float, beta2: float,
                      s0: float) -> torch.Tensor:
    """Eq. (3.2): EMA-of-losses + (beta2-beta1)-weighted EMA of differences.

    w(t) = (1-b2) sum_{k=1..t} b2^{t-k} l(k)
         + (b2-b1) sum_{k=1..t-1} b2^{t-1-k} (l(k+1)-l(k))
         + [b1 b2^{t-1} s0 + (b2-b1) b2^{t-1} l(1)]          (exact tail)
    The bracketed tail is the O(beta2^t) term of the proposition, kept
    exact so that tests can assert equality rather than asymptotics.
    """
    lh = loss_history
    t = lh.shape[0]  # steps are 1-indexed in the paper
    ema = (1 - beta2) * sum(beta2 ** (t - k) * lh[k - 1]
                            for k in range(1, t + 1))
    dif = (beta2 - beta1) * sum(beta2 ** (t - 1 - k) * (lh[k] - lh[k - 1])
                                for k in range(1, t))
    tail = (beta1 * beta2 ** (t - 1) * s0
            + (beta2 - beta1) * beta2 ** (t - 1) * lh[0])
    return ema + dif + tail


def transfer_function(beta1: float, beta2: float,
                      omega: torch.Tensor) -> torch.Tensor:
    """|H(i w)| of Thm. 3.2: the frequency response of the ES weight
    signal (``theory.transfer_gain`` on a tensor)."""
    return transfer_gain(beta1, beta2, omega)
