"""ES engine: the train-step flavours of serial and packed Evolved
Sampling (counterpart of ``repro/core/engine.py:90-455`` and :597-681).

One serial-ES step (``es_step``) runs in four legs:

1. a no-grad scoring forward over the meta-batch, through the
   flash-attention and fused cross-entropy kernels (``_score_leg``);
2. the Eq. (3.1) update of the score store, in place, through the score
   kernel, with the drift EMAs of ``CadenceState`` folded in (``_observe``);
3. Gumbel top-k selection of the mini-batch (or top-k for ``order``);
4. forward and backward on the mini-batch in plain autograd, then one
   AdamW step (``_optim``).

``baseline_step`` trains the whole meta-batch and updates the store from
the training forward's free per-sample losses. ``scheduled_step`` runs the
scoring leg only on the steps a fixed ``FreqSchedule`` fires (k = 1 is
``es_step``). The reference's ``lax.cond`` decimation is a branch on the
step counter here. ``packed_step`` and ``packed_baseline_step`` run
token-level ES on packed rows: one differentiated forward yields the
per-document losses (through the segment-sum kernel) that both score and
train. Not ported yet: ``pipelined_step``, ``prime_step``, ``flush_step``
and ``EpochSession``.

The engine is generic in the store (``ReplicatedStore`` or the int8
``QuantizedStore``). The state mutates in place: parameters and optimizer
moments in the optimizer, the score state in the store kernel. Steps
return the state for symmetry with the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.transformer import (init_lm, lm_per_sample_loss,
                                  lm_per_segment_loss, tree_leaves)
from ..optim.adamw import OptConfig, OptState, apply_updates, init_opt_state
from .frequency import FreqSchedule
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


@dataclasses.dataclass(frozen=True)
class CadenceConfig:
    """When scoring fires. The port runs the ``static`` kind (the
    ``FreqSchedule`` decides); ``drift`` is not ported yet."""
    kind: str = "static"
    rho: float = 0.8              # drift EMA decay

    def __post_init__(self):
        if self.kind != "static":
            raise NotImplementedError(
                f"cadence {self.kind!r} is not ported yet; the PyTorch port "
                f"runs 'static'")


@dataclasses.dataclass
class CadenceState:
    """Observed score-store drift (0-dim float32 tensors and ints)."""
    drift_s: torch.Tensor    # EMA of mean |ds| / mean |s| per firing
    drift_w: torch.Tensor    # EMA of mean |dw| / mean |w| per firing
    period: int              # current scoring period
    last_scored: int         # optimizer step of the last firing
    since_prune: torch.Tensor  # rel drift accumulated since the last prune


def init_cadence(device) -> CadenceState:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return CadenceState(drift_s=zero.clone(), drift_w=zero.clone(), period=1,
                        last_scored=_NEVER_SCORED, since_prune=zero.clone())


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt: OptState
    scores: Scores
    generator: torch.Generator    # selection noise
    cadence: CadenceState


def init_train_state(model_cfg: ModelConfig, es_cfg: ESConfig,
                     opt_cfg: OptConfig, seed: int, device="cuda",
                     params: Optional[Dict] = None,
                     store: Optional[Store] = None) -> TrainState:
    """Fresh state; ``params`` (e.g. from ``bridge.params_from_jax``)
    replaces the random init. Parameters and selection noise come from two
    generators seeded from ``seed``. The score leaf is ``store``'s."""
    store = store if store is not None else make_store()
    if params is None:
        pgen = torch.Generator(device=device).manual_seed(seed)
        params = init_lm(model_cfg, pgen, device)
    sel_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(params=params, opt=init_opt_state(opt_cfg, params),
                      scores=store.init_leaf(es_cfg.n_train, device),
                      generator=sel_gen, cadence=init_cadence(device))


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
                 store: Optional[Store] = None):
        self.model_cfg = model_cfg
        self.es_cfg = es_cfg
        self.opt_cfg = opt_cfg
        self.schedule = schedule
        self.store = store if store is not None else make_store()
        self.freq = freq or FreqSchedule()
        self.cadence = cadence or CadenceConfig()

    # ------------------------------------------------------------------
    # shared legs
    # ------------------------------------------------------------------
    def _loss_and_grads(self, params: Dict, batch: Batch
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """Training forward + backward -> (mean, per_sample, grads)."""
        def loss_fn():
            per_sample, mean = lm_per_sample_loss(self.model_cfg, params,
                                                  batch)
            return mean, per_sample.detach()
        return _value_and_grad(params, loss_fn)

    def _observe(self, cad: CadenceState, s_prev: torch.Tensor,
                 w_prev: torch.Tensor, losses: torch.Tensor,
                 w_new: torch.Tensor, step: int) -> CadenceState:
        """Fold one scoring firing into the drift EMAs (the period mirrors
        the static FreqSchedule)."""
        rho = self.cadence.rho
        b2 = self.es_cfg.beta2
        d_s = torch.mean(torch.abs((1.0 - b2) * (losses - s_prev)))
        d_w = torch.mean(torch.abs(w_new - w_prev))
        rel_s = d_s / (torch.mean(torch.abs(s_prev)) + _EPS)
        rel_w = d_w / (torch.mean(torch.abs(w_prev)) + _EPS)
        never = cad.last_scored <= _NEVER_SCORED // 2
        k_eff = 1.0 if never else float(max(step - cad.last_scored, 1))
        return CadenceState(
            drift_s=rho * cad.drift_s + (1.0 - rho) * rel_s / k_eff,
            drift_w=rho * cad.drift_w + (1.0 - rho) * rel_w / k_eff,
            period=self.freq.period_at(step), last_scored=step,
            since_prune=cad.since_prune + rel_s)

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
                                                batch, scoring=True)
            w, cad = self._update_store(state, batch["sample_ids"],
                                        meta_losses)
        return w, cad, meta_losses.mean()

    def _stale_leg(self, state: TrainState, batch: Batch
                   ) -> Tuple[torch.Tensor, CadenceState, torch.Tensor]:
        """Skipped scoring: the last Eq. (3.1) weights of this batch's
        samples; store and cadence untouched."""
        s_prev, w_prev = self.store.gather(state.scores, batch["sample_ids"])
        return w_prev, state.cadence, s_prev.mean()

    def _optim(self, state: TrainState, grads: Dict,
               metrics: Dict[str, torch.Tensor]) -> None:
        lr_scale = self.schedule(state.opt.step)
        metrics.update(apply_updates(self.opt_cfg, state.params, grads,
                                     state.opt, lr_scale))
        metrics["lr_scale"] = lr_scale

    # ------------------------------------------------------------------
    # step flavours
    # ------------------------------------------------------------------
    def baseline_step(self, state: TrainState, batch: Batch
                      ) -> Tuple[TrainState, Dict]:
        """Standard batched training; the store (and the drift EMAs) still
        update from the training forward's free per-sample losses."""
        mean, per_sample, grads = self._loss_and_grads(state.params, batch)
        metrics = {"loss": mean,
                   "bp_samples": float(batch["tokens"].shape[0]),
                   "scored": 0.0}
        # the store reads the pre-update step, as the reference does
        with torch.no_grad():
            _, cad = self._update_store(state, batch["sample_ids"],
                                        per_sample)
        self._optim(state, grads, metrics)
        state.cadence = cad
        return state, metrics

    def es_step(self, state: TrainState, batch: Batch, *,
                gumbel: Optional[torch.Tensor] = None
                ) -> Tuple[TrainState, Dict]:
        """Paper-faithful serial ES: score the meta-batch, update the store,
        select b of B, train on them. ``gumbel`` injects the selection
        noise (B,) instead of drawing it from the state's generator."""
        B = batch["tokens"].shape[0]
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            return self.baseline_step(state, batch)
        w, cad, meta_loss = self._score_leg(state, batch)
        idx = select_minibatch(self.es_cfg.method, w, b, store=self.store,
                               generator=state.generator, gumbel=gumbel)
        sel = _gather_batch(batch, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        metrics = {"loss": meta_loss, "sel_loss": mean,
                   "bp_samples": float(b), "w_mean": w.mean(),
                   "w_max": w.max(), "scored": 1.0, "selected": idx}
        self._optim(state, grads, metrics)
        state.cadence = cad
        return state, metrics

    def scheduled_step(self, state: TrainState, batch: Batch, *,
                       gumbel: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, Dict]:
        """Decimated ES: the scoring leg runs on the steps the fixed
        schedule fires; in between, selection uses the stale weights."""
        B = batch["tokens"].shape[0]
        b = min(self.es_cfg.minibatch, B)
        if b >= B:
            return self.baseline_step(state, batch)
        if self.freq.always_scores():
            return self.es_step(state, batch, gumbel=gumbel)
        do_score = self.freq.should_score(state.opt.step)
        leg = self._score_leg if do_score else self._stale_leg
        w, cad, meta_loss = leg(state, batch)
        idx = select_minibatch(self.es_cfg.method, w, b, store=self.store,
                               generator=state.generator, gumbel=gumbel)
        sel = _gather_batch(batch, idx)
        mean, _, grads = self._loss_and_grads(state.params, sel)
        metrics = {"loss": meta_loss if do_score else mean, "sel_loss": mean,
                   "bp_samples": float(b), "w_mean": w.mean(),
                   "w_max": w.max(), "scored": float(do_score),
                   "cad_period": float(cad.period), "selected": idx}
        self._optim(state, grads, metrics)
        state.cadence = cad
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
            per_seg, _ = lm_per_segment_loss(self.model_cfg, state.params,
                                             batch)
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
        state.cadence = cad
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
