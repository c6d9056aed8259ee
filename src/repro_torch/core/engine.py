"""ES engine: the train-step flavours of Evolved Sampling and the epoch
driver (counterpart of ``repro/core/engine.py``).

One serial-ES step (``es_step``) runs in four legs:

1. a no-grad scoring forward over the meta-batch, through the
   flash-attention and fused cross-entropy kernels (``_score_leg``);
2. the Eq. (3.1) update of the score store, in place, through the score
   kernel, with the drift EMAs of ``CadenceState`` folded in (``_observe``);
3. Gumbel top-k selection of the mini-batch (or top-k for ``order``);
4. forward and backward on the mini-batch in plain autograd, then one
   AdamW step (``_optim``); with ``OptConfig.compress_grads`` the
   gradients first go through the int8 quantize -> dequantize with error
   feedback (``distributed/compression.py``), the residuals carried in
   ``TrainState.grad_err``.

``baseline_step`` trains the whole meta-batch and updates the store from
the training forward's free per-sample losses. ``scheduled_step`` runs the
scoring leg only on the steps the cadence fires: the static
``FreqSchedule`` (fixed, warmup, adaptive) or the drift servo, which
doubles the period while the store is quiet and halves it while it moves
(k = 1 static is ``es_step``). The reference's ``lax.cond`` is a host
branch here: the decision launches the scoring kernels or does not.
``packed_step`` and ``packed_baseline_step`` run token-level ES on packed
rows: one differentiated forward yields the per-document losses (through
the segment-sum kernel) that both score and train.

Pipelined ES (``pipelined_step``) trains meta-batch t on the weights
scored for it one step earlier (``TrainState.pending_w``) while it scores
meta-batch t+1 with the same pre-update parameters; ``prime_step`` scores
an epoch's first batch and ``flush_step`` trains its last.
``EpochSession`` drives an epoch through them. On CUDA the scoring leg
runs on a second stream (``_scoring_stream``) and overlaps the training leg;
on the CPU the same legs run in the same order, one after the other.

Host syncs a step makes in the engine: none for the static cadence; one
per firing for the drift cadence (``_settle`` reads the servo's
comparison, after the step's work is enqueued). The trainer adds one a
step, its read of the loss.

The engine is generic in the store (``ReplicatedStore``, the row blocks
of ``ShardedStore``, or the int8 ``QuantizedStore`` over either): a gather
returns on the ids' device, the model's, wherever the rows lie. The state
mutates in place: parameters and optimizer moments in the optimizer, the
score state in the store kernel. Steps return the state for symmetry with
the reference.

On a mesh (``ctx``, the reference's ``ShardCtx``: dense, MoE, SSM and
hybrid models) each rank holds its shards of the state and its rows of
every batch (over the data axes). The scoring forward's losses and the
sample ids are all-gathered, so every rank updates its copy of the
replicated store with the same B ids and draws the same Gumbel top-k (the
same generator seed); the selected rows are taken from the all-gathered
batch, b / dp a rank. The training loss is the rank's share of the
mini-batch mean; the gradients of leaves replicated over the data axes are
all-reduced over them, those FSDP splits were reduce-scattered by their
gathers' backward. Packed steps are not sharded (nor are the reference's).
A checkpoint of the state passes ``checkpoint_layout()`` to the
checkpointer, which saves each split leaf whole and restores it onto any
grid or one process.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..checkpoint.checkpointer import Layout, ShardTree
from ..configs.base import ModelConfig
from ..distributed.compression import ErrorFeedbackState, compress_decompress
from ..models.layers import ShardCtx
from ..models.transformer import (init_lm, lm_per_sample_loss,
                                  lm_per_segment_loss, param_axes,
                                  tree_leaves)
from ..optim.adamw import OptConfig, OptState, apply_updates, init_opt_state
from .frequency import ADAPTIVE_DEFAULT_CAP, FreqSchedule
from .scores import Scores, Store, make_store, weights_from_prev
from .selection import masked_select_kept, select_minibatch

Batch = Dict[str, torch.Tensor]

_EPS = 1e-12
_NEVER_SCORED = -(1 << 20)   # CadenceState.last_scored init: step 0 fires


@dataclasses.dataclass(frozen=True)
class ESConfig:
    method: str = "es"            # es | loss | order
    beta1: float = 0.2
    beta2: float = 0.9
    minibatch: int = 64           # b (selected for BP)
    n_train: int = 1 << 20        # score-store size
    fused_scores: bool = True     # score kernel vs the scatter form
    seq_chunk: int = 1024         # training xent: sequence chunks


@dataclasses.dataclass(frozen=True)
class CadenceConfig:
    """When scoring fires. ``static``: the engine's ``FreqSchedule``
    decides. ``drift``: the servo doubles the period (up to ``k_cap``)
    while the drift EMA is below ``target / band`` and halves it above
    ``target * band``. The prune fields gate set-level pruning
    (``ESEngine.prune_decision``): ``epoch`` re-prunes before every
    epoch; ``drift`` once the relative drift accumulated since the last
    prune reaches ``prune_drift_floor``, and at least every
    ``prune_max_interval`` epochs."""
    kind: str = "static"          # static | drift
    rho: float = 0.8              # drift EMA decay
    target: float = 0.05          # relative |ds| drift the servo tracks
    band: float = 2.0             # hysteresis: grow < target/band,
    #                               shrink > target*band
    k_cap: int = 64               # drift: max scoring period
    prune_kind: str = "epoch"     # epoch | drift
    prune_drift_floor: float = 0.25
    prune_max_interval: int = 4

    def __post_init__(self):
        if self.kind not in ("static", "drift"):
            raise ValueError(f"unknown cadence kind {self.kind!r}")
        if self.prune_kind not in ("epoch", "drift"):
            raise ValueError(f"unknown prune cadence {self.prune_kind!r}")
        if self.k_cap < 1:
            raise ValueError(f"k_cap must be >= 1, got {self.k_cap}")


@dataclasses.dataclass
class CadenceState:
    """Observed score-store drift (0-dim float32 tensors) and the host
    ints that decide the next firing. ``servo`` is the drift cadence's
    pending decision of the last firing (0-dim int8: 1 grow, -1 shrink,
    0 hold) until ``ESEngine._settle`` folds it into ``period``."""
    drift_s: torch.Tensor    # EMA of mean |ds| / mean |s| per step
    drift_w: torch.Tensor    # EMA of mean |dw| / mean |w| per step
    period: int              # current scoring period
    last_scored: int         # optimizer step of the last firing
    since_prune: torch.Tensor  # rel drift accumulated since the last prune
    servo: Optional[torch.Tensor] = None


def init_cadence(device) -> CadenceState:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return CadenceState(drift_s=zero.clone(), drift_w=zero.clone(), period=1,
                        last_scored=_NEVER_SCORED, since_prune=zero.clone())


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt: OptState
    scores: Scores
    generator: Optional[torch.Generator]  # selection noise (None on meta)
    cadence: CadenceState
    pending_w: torch.Tensor       # (B,) pipelined ES: carried weights
    grad_err: Optional[Dict] = None  # error-feedback residuals (f32)


def init_train_state(model_cfg: ModelConfig, es_cfg: ESConfig,
                     opt_cfg: OptConfig, seed: int, device="cuda",
                     params: Optional[Dict] = None,
                     store: Optional[Store] = None, *,
                     meta_batch: int = 1,
                     ctx: ShardCtx = ShardCtx()) -> TrainState:
    """Fresh state; ``params`` (e.g. from ``bridge.params_from_jax``)
    replaces the random init. Parameters and selection noise come from two
    generators seeded from ``seed``. The score leaf is ``store``'s;
    ``pending_w`` starts at 1 for each of the ``meta_batch`` rows;
    ``grad_err`` is float32 zeros per parameter when the optimizer
    compresses its gradients. On a mesh the parameters and moments are
    this rank's shards; the store, the cadence and ``pending_w`` are
    replicated."""
    store = store if store is not None else make_store()
    if params is None:
        params = init_lm(model_cfg, _generator(device, seed), device, ctx)
    sel_gen = _generator(device, seed + 1)
    return TrainState(params=params, opt=init_opt_state(opt_cfg, params),
                      scores=store.init_leaf(es_cfg.n_train, device),
                      generator=sel_gen, cadence=init_cadence(device),
                      pending_w=torch.ones(meta_batch, dtype=torch.float32,
                                           device=device),
                      grad_err=ErrorFeedbackState.init(params)
                      if opt_cfg.compress_grads else None)


def _generator(device, seed: int) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None on ``meta``,
    which has no generator and whose draws hold no data (the dry run's
    trace, ``launch/dryrun.py``)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _gather_batch(batch: Batch, idx: torch.Tensor) -> Batch:
    idx = idx.long()
    return {k: v[idx] for k, v in batch.items()}


class ESEngine:
    """Train steps assembled from the scoring, selection and cadence
    policies, over one score store."""

    def __init__(self, model_cfg: ModelConfig, es_cfg: ESConfig,
                 opt_cfg: OptConfig, schedule: Callable[[int], float],
                 freq: Optional[FreqSchedule] = None,
                 cadence: Optional[CadenceConfig] = None,
                 store: Optional[Store] = None,
                 ctx: ShardCtx = ShardCtx()):
        self.model_cfg = model_cfg
        self.es_cfg = es_cfg
        self.opt_cfg = opt_cfg
        self.schedule = schedule
        self.ctx = ctx
        self.dp = ctx.size("batch")
        # each leaf's logical axes, for the data-parallel gradient sum and
        # the clip's norm over shards
        self._axes = param_axes(model_cfg) if ctx.mesh is not None else None
        self.store = store if store is not None else make_store()
        self.freq = freq or FreqSchedule()
        if cadence is None:
            # a drift FreqSchedule implies the drift cadence with its k as
            # the cap; a cap of 1 opens to the default cap, as
            # make_schedule does (pass CadenceConfig(k_cap=1) to pin it)
            if self.freq.kind == "drift":
                cap = self.freq.target_period
                cadence = CadenceConfig(
                    kind="drift",
                    k_cap=cap if cap > 1 else ADAPTIVE_DEFAULT_CAP)
            else:
                cadence = CadenceConfig()
        self.cadence = cadence
        self._side: Optional[torch.cuda.Stream] = None

    # ------------------------------------------------------------------
    # shared legs
    # ------------------------------------------------------------------
    def _loss_and_grads(self, params: Dict, batch: Batch
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """Training forward + backward -> (mean, per_sample, grads); the
        mean is weighted by ``batch["grad_scale"]`` when present (the
        InfoBatch rescale)."""
        scale = batch.get("grad_scale")

        def loss_fn():
            per_sample, mean = lm_per_sample_loss(
                self.model_cfg, params, batch,
                seq_chunk=self.es_cfg.seq_chunk, ctx=self.ctx)
            if scale is not None:
                mean = torch.mean(per_sample * scale.to(torch.float32))
            if self.dp > 1:       # this rank's share of the batch mean
                mean = mean / self.dp
            return mean, per_sample.detach()
        mean, per_sample, grads = _value_and_grad(params, loss_fn)
        if self.ctx.mesh is None:
            return mean, per_sample, grads
        return (self.ctx.all_reduce(mean, "batch"), per_sample,
                self._sync_grads(grads))

    def _sync_grads(self, grads: Dict) -> Dict:
        """Sum each gradient leaf that the data axes replicate over them
        (an FSDP leaf's gather already reduce-scattered its own)."""
        dp = set(self.ctx.dims("batch"))

        def fix(g, axes):
            if isinstance(g, dict):
                return {k: fix(g[k], axes[k]) for k in g}
            if any(dp & set(self.ctx.dims(a)) for a in axes):
                return g
            return self.ctx.all_reduce(g, "batch")
        return fix(grads, self._axes) if dp else grads

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole meta-batch's rows of a per-row tensor (all-gathered
        over the data axes)."""
        return self.ctx.all_gather(t, "batch", 0)

    def _select_rows(self, batch: Batch, idx: torch.Tensor) -> Batch:
        """The selected rows this rank trains on: its b / dp of ``idx``
        (global row indices), taken from the all-gathered batch."""
        if self.dp == 1:
            return _gather_batch(batch, idx)
        lo, n = self.ctx.local("batch", idx.shape[0])
        rows = {k: self._all_rows(v) for k, v in batch.items()}
        return _gather_batch(rows, idx[lo:lo + n])

    def _observe(self, cad: CadenceState, s_prev: torch.Tensor,
                 w_prev: torch.Tensor, losses: torch.Tensor,
                 w_new: torch.Tensor, step: int) -> CadenceState:
        """Fold one scoring firing into the drift EMAs. The EMAs take the
        per-step drift (the observed one over the steps since the last
        firing). Static cadence: the period mirrors the FreqSchedule.
        Drift: the servo's decision is left pending on the device
        (``servo``) for ``_settle`` to read."""
        c = self.cadence
        b2 = self.es_cfg.beta2
        d_s = torch.mean(torch.abs((1.0 - b2) * (losses - s_prev)))
        d_w = torch.mean(torch.abs(w_new - w_prev))
        rel_s = d_s / (torch.mean(torch.abs(s_prev)) + _EPS)
        rel_w = d_w / (torch.mean(torch.abs(w_prev)) + _EPS)
        never = cad.last_scored <= _NEVER_SCORED // 2
        k_eff = 1.0 if never else float(max(step - cad.last_scored, 1))
        drift_s = c.rho * cad.drift_s + (1.0 - c.rho) * rel_s / k_eff
        drift_w = c.rho * cad.drift_w + (1.0 - c.rho) * rel_w / k_eff
        servo, period = None, cad.period
        if c.kind == "drift":
            one = torch.ones((), dtype=torch.int8, device=drift_s.device)
            servo = torch.where(drift_s < c.target / c.band, one,
                                torch.where(drift_s > c.target * c.band,
                                            -one, 0 * one))
        else:
            period = self.freq.period_at(step)
        return CadenceState(drift_s=drift_s, drift_w=drift_w, period=period,
                            last_scored=step,
                            since_prune=cad.since_prune + rel_s, servo=servo)

    def _settle(self, cad: CadenceState, done=None) -> CadenceState:
        """Fold a pending drift-servo decision into the host period: the
        cadence's one host read a firing, made once the step's work is
        enqueued. ``done`` (the event of a scoring leg that ran on the
        side stream) makes the read wait for that leg only."""
        if cad.servo is None:
            return cad
        if done is None:
            move = int(cad.servo)
        else:
            with torch.cuda.stream(self._side):
                move = int(cad.servo)
        period = cad.period * 2 if move > 0 else (
            cad.period // 2 if move < 0 else cad.period)
        return dataclasses.replace(
            cad, period=min(max(period, 1), self.cadence.k_cap), servo=None)

    def _fire(self, state: TrainState) -> bool:
        """Does this step run the (decimated) scoring forward?"""
        step = state.opt.step
        if self.cadence.kind == "drift":
            return step - state.cadence.last_scored >= state.cadence.period
        return self.freq.should_score(step)

    def _update_store(self, state: TrainState, ids: torch.Tensor,
                      losses: torch.Tensor
                      ) -> Tuple[torch.Tensor, CadenceState]:
        """Eq. (3.1) weights, drift EMAs and the in-place store update,
        from one batch's losses -> (weights, new cadence)."""
        s_prev, w_prev = self.store.gather(state.scores, ids)
        w = weights_from_prev(s_prev, losses, self.es_cfg.beta1)
        cad = self._observe(state.cadence, s_prev, w_prev, losses, w,
                            state.opt.step)
        self.store.update(state.scores, ids, losses, self.es_cfg.beta1,
                          self.es_cfg.beta2, fused=self.es_cfg.fused_scores)
        return w, cad

    def _score_leg(self, state: TrainState, batch: Batch
                   ) -> Tuple[torch.Tensor, CadenceState, torch.Tensor]:
        """No-grad scoring forward (kernels) + Eq. (3.1) + cadence
        bookkeeping -> (weights, new cadence, meta loss)."""
        with torch.no_grad():
            meta_losses, _ = lm_per_sample_loss(self.model_cfg, state.params,
                                                batch, scoring=True,
                                                ctx=self.ctx)
            meta_losses = self._all_rows(meta_losses)
            w, cad = self._update_store(
                state, self._all_rows(batch["sample_ids"]), meta_losses)
        return w, cad, meta_losses.mean()

    def _stale_leg(self, state: TrainState, batch: Batch
                   ) -> Tuple[torch.Tensor, CadenceState, torch.Tensor]:
        """Skipped scoring: the last Eq. (3.1) weights of this batch's
        samples; store and cadence untouched."""
        s_prev, w_prev = self.store.gather(
            state.scores, self._all_rows(batch["sample_ids"]))
        return w_prev, state.cadence, s_prev.mean()

    def _optim(self, state: TrainState, grads: Dict,
               metrics: Dict[str, torch.Tensor]) -> None:
        """One optimizer step; every step flavour ends here. With
        ``compress_grads`` each gradient leaf is replaced by its int8
        quantize -> dequantize (the lossy leg of the compressed DP
        all-reduce, on the wire's per-block grid) and its residual is
        written over ``grad_err`` in place, leaf by leaf."""
        if self.opt_cfg.compress_grads:
            out = []
            for g, err in zip(tree_leaves(grads),
                              tree_leaves(state.grad_err)):
                deq, new_err = compress_decompress(g, err)
                err.copy_(new_err)
                out.append(deq)
            grads = _rebuild(grads, iter(out))
        lr_scale = self.schedule(state.opt.step)
        metrics.update(apply_updates(self.opt_cfg, state.params, grads,
                                     state.opt, lr_scale, self.ctx,
                                     self._axes))
        metrics["lr_scale"] = lr_scale

    def _scoring_stream(self, state: TrainState, fn: Callable,
                        batch: Batch):
        """Run the scoring leg ``fn()`` -> (w, cad, loss) on the side
        stream when the batch lies on a CUDA device, else inline.
        -> (w, cad, loss, event marking the leg's end or None).

        The side stream first waits for all the default stream has
        enqueued (the previous AdamW, store update and the batch's copy).
        Tensors the leg reads that another stream allocated (the batch,
        the cadence EMAs) are recorded on the side stream, and those it
        hands to the default stream are recorded there, so the caching
        allocator reuses no block while a stream still reads it."""
        dev = batch["tokens"].device
        if dev.type != "cuda":
            return (*fn(), None)
        main = torch.cuda.current_stream(dev)
        if self._side is None:      # one scoring stream per engine
            self._side = torch.cuda.Stream(device=dev)
        side = self._side
        side.wait_stream(main)
        cad = state.cadence
        for t in (*batch.values(), cad.drift_s, cad.drift_w,
                  cad.since_prune):
            t.record_stream(side)
        with torch.cuda.stream(side):
            w, cad, loss = fn()
            done = torch.cuda.Event()
            done.record(side)
        for t in (w, loss, cad.drift_s, cad.drift_w, cad.since_prune,
                  cad.servo):
            if t is not None:
                t.record_stream(main)
        return w, cad, loss, done

    def _join(self, done) -> None:
        """The default stream waits for the scoring leg's end."""
        if done is not None:
            torch.cuda.current_stream(self._side.device).wait_event(done)

    # ------------------------------------------------------------------
    # step flavours
    # ------------------------------------------------------------------
    def baseline_step(self, state: TrainState, batch: Batch
                      ) -> Tuple[TrainState, Dict]:
        """Standard batched training; the store (and the drift EMAs) still
        update from the training forward's free per-sample losses."""
        mean, per_sample, grads = self._loss_and_grads(state.params, batch)
        metrics = {"loss": mean,
                   "bp_samples": float(batch["tokens"].shape[0] * self.dp),
                   "scored": 0.0}
        # the store reads the pre-update step, as the reference does
        with torch.no_grad():
            _, cad = self._update_store(
                state, self._all_rows(batch["sample_ids"]),
                self._all_rows(per_sample))
        self._optim(state, grads, metrics)
        state.cadence = self._settle(cad)
        return state, metrics

    def es_step(self, state: TrainState, batch: Batch, *,
                gumbel: Optional[torch.Tensor] = None
                ) -> Tuple[TrainState, Dict]:
        """Paper-faithful serial ES: score the meta-batch, update the store,
        select b of B, train on them. ``gumbel`` injects the selection
        noise (B,) instead of drawing it from the state's generator."""
        B = batch["tokens"].shape[0] * self.dp
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            return self.baseline_step(state, batch)
        w, cad, meta_loss = self._score_leg(state, batch)
        idx = select_minibatch(self.es_cfg.method, w, b, store=self.store,
                               generator=state.generator, gumbel=gumbel)
        sel = self._select_rows(batch, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        metrics = {"loss": meta_loss, "sel_loss": mean,
                   "bp_samples": float(b), "w_mean": w.mean(),
                   "w_max": w.max(), "scored": 1.0, "selected": idx}
        self._optim(state, grads, metrics)
        state.cadence = self._settle(cad)
        return state, metrics

    def scheduled_step(self, state: TrainState, batch: Batch, *,
                       gumbel: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, Dict]:
        """Decimated ES: the scoring leg runs on the steps the cadence
        fires (static schedule or drift servo); in between, selection uses
        the stale weights."""
        B = batch["tokens"].shape[0] * self.dp
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            return self.baseline_step(state, batch)
        if self.cadence.kind != "drift" and self.freq.always_scores():
            return self.es_step(state, batch, gumbel=gumbel)
        do_score = self._fire(state)
        leg = self._score_leg if do_score else self._stale_leg
        w, cad, meta_loss = leg(state, batch)
        idx = select_minibatch(self.es_cfg.method, w, b, store=self.store,
                               generator=state.generator, gumbel=gumbel)
        sel = self._select_rows(batch, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        metrics = {"loss": meta_loss if do_score else mean, "sel_loss": mean,
                   "bp_samples": float(b), "w_mean": w.mean(),
                   "w_max": w.max(), "scored": float(do_score),
                   "selected": idx}
        self._optim(state, grads, metrics)
        state.cadence = self._settle(cad)
        metrics["cad_period"] = float(state.cadence.period)
        return state, metrics

    def pipelined_step(self, state: TrainState,
                       batches: Tuple[Batch, Batch], *,
                       gumbel: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, Dict]:
        """batches = (current, next). Train on ``current`` with the weights
        scored for it last step (``state.pending_w``) while scoring
        ``next`` with the pre-update parameters (one step stale). The
        scoring leg honours the cadence; on a skipped step ``next``'s
        weights come from the stale store.

        On CUDA the scoring leg runs on the side stream and the training
        leg on the default stream; the default stream waits for the
        scoring leg before AdamW, which updates the parameters the leg
        reads in place."""
        cur, nxt = batches
        B = cur["tokens"].shape[0] * self.dp
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            # no sub-selection: scoring rides the training forward
            return self.baseline_step(state, cur)
        if self.cadence.kind != "drift" and self.freq.always_scores():
            do_score = True
        else:
            do_score = self._fire(state)
        leg = self._score_leg if do_score else self._stale_leg
        w_next, cad, nxt_loss, done = self._scoring_stream(
            state, lambda: leg(state, nxt), nxt)
        idx = select_minibatch(self.es_cfg.method, state.pending_w, b,
                               store=self.store, generator=state.generator,
                               gumbel=gumbel)
        sel = self._select_rows(cur, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        self._join(done)
        metrics = {"loss": nxt_loss if do_score else mean, "sel_loss": mean,
                   "bp_samples": float(b), "scored": float(do_score),
                   "selected": idx}
        self._optim(state, grads, metrics)
        state.pending_w = w_next
        state.cadence = self._settle(cad, done)
        metrics["cad_period"] = float(state.cadence.period)
        return state, metrics

    def prime_step(self, state: TrainState, batch: Batch) -> TrainState:
        """Scoring only (pipelined epoch start): fill ``pending_w`` for the
        first meta-batch. No optimizer update. The firing is backdated one
        step, so a period-1 cadence still scores the first pipelined step
        (which runs at the same optimizer step)."""
        B = batch["tokens"].shape[0] * self.dp
        if min(self.es_cfg.minibatch, B) >= B:
            return state        # baseline steps: nothing to prime
        w, cad, _, done = self._scoring_stream(
            state, lambda: self._score_leg(state, batch), batch)
        self._join(done)
        cad = dataclasses.replace(cad, last_scored=state.opt.step - 1)
        state.pending_w = w
        state.cadence = self._settle(cad, done)
        return state

    def flush_step(self, state: TrainState, batch: Batch, *,
                   gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict]:
        """Train only (pipelined epoch end): the held meta-batch with its
        carried weights; no next batch, so no scoring leg."""
        B = batch["tokens"].shape[0] * self.dp
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            return self.baseline_step(state, batch)
        idx = select_minibatch(self.es_cfg.method, state.pending_w, b,
                               store=self.store, generator=state.generator,
                               gumbel=gumbel)
        sel = self._select_rows(batch, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        metrics = {"loss": mean, "sel_loss": mean, "bp_samples": float(b),
                   "scored": 0.0, "selected": idx}
        self._optim(state, grads, metrics)
        return state, metrics

    def _packed_impl(self, state: TrainState, batch: Batch, select: bool,
                     gumbel: Optional[torch.Tensor]
                     ) -> Tuple[TrainState, Dict]:
        """Segment-granular ES on a packed batch.

        One differentiated forward serves scoring and training: the
        detached per-document NLLs feed Eq. (3.1) against the gathered
        prior scores, the masked Gumbel top-k keeps b of the valid
        document slots, and the training loss is the kept-slot mean, so a
        dropped document's term is multiplied by exactly zero. The store
        is keyed by global document ids (``batch["doc_ids"]``); empty or
        pruned slots carry -1, which the stores drop.
        """
        if self.ctx.mesh is not None:
            raise NotImplementedError("packed steps on a mesh: the "
                                      "reference shards no packed step")
        doc_ids = batch["doc_ids"]                       # (B, M)
        n = doc_ids.numel()
        flat_ids = doc_ids.reshape(n)
        valid = flat_ids >= 0
        validf = valid.to(torch.float32)
        safe = torch.where(valid, flat_ids, torch.zeros_like(flat_ids))
        s_prev, w_prev = self.store.gather(state.scores, safe)
        b = min(self.es_cfg.minibatch, n)
        select = select and b < n
        gs = batch.get("doc_grad_scale")
        scale = gs.reshape(n).to(torch.float32) if gs is not None \
            else torch.ones(n, dtype=torch.float32, device=flat_ids.device)
        zero = torch.zeros((), dtype=torch.float32, device=flat_ids.device)

        def loss_fn():
            per_seg, _ = lm_per_segment_loss(
                self.model_cfg, state.params, batch,
                seq_chunk=self.es_cfg.seq_chunk)
            per_seg = per_seg.reshape(n)
            losses = per_seg.detach()
            w = torch.where(valid, weights_from_prev(s_prev, losses,
                                                     self.es_cfg.beta1),
                            zero)
            if select:
                kept = masked_select_kept(self.es_cfg.method, w, valid, b,
                                          generator=state.generator,
                                          gumbel=gumbel)
            else:
                kept = valid
            kf = kept.to(torch.float32)
            mean = (torch.sum(per_seg * kf * scale)
                    / torch.clamp(torch.sum(kf), min=1.0))
            return mean, (losses, w, kept)

        mean, (losses, w, kept), grads = _value_and_grad(state.params,
                                                         loss_fn)
        with torch.no_grad():
            n_valid = torch.clamp(torch.sum(validf), min=1.0)
            metrics = {
                "loss": torch.sum(losses * validf) / n_valid,
                "sel_loss": mean,
                "bp_samples": torch.sum(kept.to(torch.float32)),
                "seg_valid": torch.sum(validf),
                "w_mean": torch.sum(w) / n_valid,
                "w_max": torch.max(w),
                # scoring rides the training forward: no scoring forward ran
                "scored": 0.0,
                "kept": kept,
            }
            # invalid slots observe zero drift and update nothing (-1 drops)
            cad = self._observe(state.cadence, s_prev, w_prev,
                                torch.where(valid, losses, s_prev),
                                torch.where(valid, w, w_prev),
                                state.opt.step)
            self.store.update(state.scores,
                              torch.where(valid, flat_ids,
                                          torch.full_like(flat_ids, -1)),
                              losses, self.es_cfg.beta1, self.es_cfg.beta2,
                              fused=self.es_cfg.fused_scores)
        self._optim(state, grads, metrics)
        state.cadence = self._settle(cad)
        return state, metrics

    def packed_step(self, state: TrainState, batch: Batch, *,
                    gumbel: Optional[torch.Tensor] = None
                    ) -> Tuple[TrainState, Dict]:
        """Packed batch with document-level selection (scoring fused into
        the training forward). ``gumbel`` (B*M,) injects the noise."""
        return self._packed_impl(state, batch, True, gumbel)

    def packed_baseline_step(self, state: TrainState, batch: Batch, *,
                             gumbel: Optional[torch.Tensor] = None
                             ) -> Tuple[TrainState, Dict]:
        """Packed batch, selection off: every valid document trains; the
        store still updates from the free per-document losses. ``gumbel``
        is accepted for symmetry and unused."""
        return self._packed_impl(state, batch, False, gumbel)

    # ------------------------------------------------------------------
    # host-side API
    # ------------------------------------------------------------------
    def session(self, selection_on: bool, pipelined: bool) -> "EpochSession":
        """One epoch's driver (see ``EpochSession``)."""
        return EpochSession(self, selection_on, pipelined)

    # -- set-level (epoch) pruning cadence ------------------------------
    def prune_decision(self, cad: Optional[CadenceState],
                       epochs_since_prune: int) -> Tuple[bool, str]:
        """Does set-level pruning re-run before this epoch? -> (fired,
        reason), the reason being what the trainer's ``prune_events``
        record.

        ``epoch`` cadence: always. ``drift`` cadence: once the relative
        score drift accumulated since the last prune reaches the floor (a
        converged store keeps its kept-set), with a max-interval backstop
        on the age of a kept-set. ``epochs_since_prune`` counts the epoch
        being gated, so ``prune_max_interval = N`` prunes at least every
        N epochs. Reads ``cad.since_prune`` from the device (one sync).
        """
        if self.cadence.prune_kind == "epoch":
            return True, "epoch-cadence"
        if epochs_since_prune >= self.cadence.prune_max_interval:
            return True, "max-interval"
        if cad is None:
            return True, "no-cadence-state"
        if float(cad.since_prune) >= self.cadence.prune_drift_floor:
            return True, "drift"
        return False, "drift-below-floor"

    def should_prune(self, cad: Optional[CadenceState],
                     epochs_since_prune: int) -> bool:
        return self.prune_decision(cad, epochs_since_prune)[0]

    def reset_prune_drift(self, state: TrainState) -> TrainState:
        """Zero the drift accumulated since the last prune."""
        state.cadence = dataclasses.replace(
            state.cadence, since_prune=torch.zeros_like(
                state.cadence.since_prune))
        return state

    def state_dict(self, state: TrainState) -> Dict:
        """``state`` as nested dicts of tensors, for a checkpoint: the
        parameters, the optimizer's moments and step, the store's leaf
        (one tensor a field, ``Store.leaf_state``: a sharded leaf's blocks
        concatenated),
        ``pending_w``, the cadence (a pending servo settled first: it is
        what the next step would read), the selection generator's state
        (a CUDA generator's is its seed and offset; re-seeding it would
        draw other noise) and, with gradient compression, ``grad_err``.
        On a mesh a ``ShardTree`` (its parameters and moments are this
        rank's shards; ``checkpoint_layout``)."""
        state.cadence = self._settle(state.cadence)
        cad, opt = state.cadence, state.opt
        dev = state.pending_w.device

        def i64(x: int) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.int64, device=dev)

        tree = {"params": state.params,
                "opt": {"m": opt.m, "step": i64(opt.step)},
                "scores": self.store.leaf_state(state.scores),
                "pending_w": state.pending_w,
                "cadence": {"drift_s": cad.drift_s, "drift_w": cad.drift_w,
                            "since_prune": cad.since_prune,
                            "period": i64(cad.period),
                            "last_scored": i64(cad.last_scored)},
                "generator": state.generator.get_state()}
        if opt.v is not None:
            tree["opt"]["v"] = opt.v
        if state.grad_err is not None:
            tree["grad_err"] = state.grad_err
        layout = self.checkpoint_layout()
        return tree if layout is None else ShardTree(tree, layout)

    def checkpoint_layout(self) -> Optional[Layout]:
        """Which leaves of ``state_dict`` are this rank's shards (the
        parameters, both AdamW moments and ``grad_err`` take
        ``param_axes``; the store's leaves, whole on every rank, keep
        their partition) -> the checkpointer's ``layout``; None with no
        mesh."""
        if self.ctx.mesh is None:
            return None
        pa = self._axes
        return Layout({"params": pa, "opt": {"m": pa, "v": pa},
                       "grad_err": pa}, self.ctx)

    def load_state_dict(self, state: TrainState, tree: Dict) -> TrainState:
        """The ``TrainState`` that ``state_dict`` saved as ``tree`` (leaves
        already on ``state``'s devices and dtypes, e.g. from
        ``Checkpointer.restore(self.state_dict(state))``)."""
        opt, cad = tree["opt"], tree["cadence"]
        state.generator.set_state(tree["generator"])
        return TrainState(
            params=tree["params"],
            opt=OptState(step=int(opt["step"]), m=opt["m"],
                         v=opt.get("v")),
            scores=self.store.load_leaf_state(tree["scores"], state.scores),
            generator=state.generator,
            cadence=CadenceState(drift_s=cad["drift_s"],
                                 drift_w=cad["drift_w"],
                                 period=int(cad["period"]),
                                 last_scored=int(cad["last_scored"]),
                                 since_prune=cad["since_prune"]),
            pending_w=tree["pending_w"], grad_err=tree.get("grad_err"))


class EpochSession:
    """Per-epoch host driver: one entry point for every scoring policy.

    Dispatches each batch to the engine's step and owns the pipelined
    prime / carry / flush protocol:

      * first batch: ``prime_step`` scores it (fills ``pending_w``) and the
        batch is held; ``step`` returns ``(state, None)``;
      * each later batch: ``pipelined_step`` trains the held batch while
        scoring the new one;
      * ``finish`` trains the held batch with ``flush_step``, so an
        epoch's last meta-batch is not dropped.

    Other sessions route to ``scheduled_step`` (serial ES at k = 1) or
    ``baseline_step`` when selection is annealed off; packed batches run
    the packed steps, serially (their scoring rides the training forward).
    """

    def __init__(self, engine: ESEngine, selection_on: bool,
                 pipelined: bool):
        self.engine = engine
        self.selection_on = selection_on
        self.pipelined = pipelined and selection_on
        self._held: Optional[Batch] = None
        # scoring forwards run by primes (not in any step's metrics: the
        # trainer folds them into scoring_steps_total)
        self.scoring_primes = 0

    @property
    def has_held(self) -> bool:
        """True while a primed meta-batch waits to be trained (the
        checkpoint cursor records it, so a resume can rebuild it)."""
        return self._held is not None

    def resume_held(self, batch: Batch) -> None:
        """Reinstall the held meta-batch after a mid-epoch restore. The
        restored ``pending_w`` holds the weights scored for it before the
        checkpoint, so no re-prime runs (one would score it with the
        restored, later parameters and leave the uninterrupted run's
        trajectory)."""
        if not self.pipelined or self._held is not None:
            raise RuntimeError("resume_held: needs a pipelined session "
                               "with no held batch")
        self._held = batch

    def run(self, state: TrainState, stream, on_metrics=None) -> TrainState:
        """Step every batch of ``stream``; ``on_metrics(metrics)`` fires
        after each trained step and stops the epoch when it returns
        truthy. The caller still calls ``finish``."""
        for batch in stream:
            state, m = self.step(state, batch)
            if m is not None and on_metrics is not None and on_metrics(m):
                break
        return state

    def step(self, state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Optional[Dict]]:
        eng = self.engine
        if "doc_ids" in batch:
            if self.selection_on:
                return eng.packed_step(state, batch)
            return eng.packed_baseline_step(state, batch)
        if not self.selection_on:
            return eng.baseline_step(state, batch)
        if not self.pipelined:
            return eng.scheduled_step(state, batch)
        if self._held is None:
            B = batch["tokens"].shape[0] * eng.dp
            if min(eng.es_cfg.minibatch, B) < B:
                self.scoring_primes += 1   # b >= B primes are no-ops
            state = eng.prime_step(state, batch)
            self._held = batch
            return state, None
        state, m = eng.pipelined_step(state, (self._held, batch))
        self._held = batch
        return state, m

    def finish(self, state: TrainState
               ) -> Tuple[TrainState, Optional[Dict]]:
        if self._held is None:
            return state, None
        held, self._held = self._held, None
        return self.engine.flush_step(state, held)


def _value_and_grad(params: Dict, loss_fn: Callable):
    """Run ``loss_fn() -> (loss, aux)`` with gradients on the parameter
    leaves -> (detached loss, aux, grads); the leaves stop requiring
    gradients afterwards."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), aux, _rebuild(params, iter(grads))


def _rebuild(tree, it):
    """A dict shaped like ``tree`` whose leaves come from ``it`` (in the
    ``tree_leaves`` order)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)
