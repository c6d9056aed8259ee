"""The ES trainer and its CLI (counterpart of ``repro/launch/train.py``:
``Trainer`` :104-265, ``_make_score_sharding`` :268-290,
``_grow_store``/``grow`` :293-321,
``_resume``/``_checkpoint`` :323-395, ``_prune_for_epoch`` :397-435,
``_record``/``train`` :437-588, ``main`` :591).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --full --method es \\
        --meta-batch 32 --minibatch 8 --seq-len 512 --n-samples 1024 \\
        --max-steps 4
    # pipelined ES (scoring of batch t+1 overlaps training on batch t)
    ... --pipelined
    # the drift-servoed scoring period, capped at 8
    ... --freq-schedule drift --score-every 8
    # packed, token-level ES (--n-samples counts documents)
    ... --pack --max-segments 4 --meta-batch 16 --minibatch 16
    # the int8 score store
    ... --quant-scores --quant-block 1024
    # the store in row blocks, one a device of the run (int8: the wire)
    ... --shard-scores
    ... --shard-scores --quant-scores --quant-wire
    # ESWP: ES steps plus a kept-set of 80 % of the samples, re-drawn
    # before each epoch (or, --prune-cadence drift, when the scores moved)
    ... --method eswp --prune-cadence drift
    # set-level pruning alone (baseline steps): infobatch, ucb, ka, random
    ... --method infobatch
    # checkpoints every 50 steps and at the end; run again to resume
    ... --ckpt-dir /path/to/ckpts
    # a token file (uint16 windows of --seq-len + 1), a glob of them, or
    # prompt/response JSONL; one host's slice of each global meta-batch
    ... --source tokens --data-path corpus.bin --num-hosts 2 --host-id 1
    ... --source sharded --data-path 'shards/*.bin'
    ... --source sft --data-path pairs.jsonl

The flags are the JAX CLI's. What the port runs: the batch-level methods
``es``, ``loss``, ``order`` and ``baseline``, and the set-level ones
``eswp`` (ES steps over a pruned set), ``infobatch``, ``ucb``, ``ka`` and
``random`` (baseline steps over a pruned set), pruned before every epoch
or on the drift cadence (``--prune-cadence epoch|drift``); serial or
pipelined ES (``--pipelined``); the
four scoring cadences (``--freq-schedule fixed|warmup|adaptive|drift``
with ``--score-every``, ``--gain-floor``, ``--drift-target``); the
synthetic source, the packed synthetic documents (``--pack``,
``--source packed``), token files (``--source tokens|sharded`` with
``--data-path``) or SFT pairs (``--source sft``, JSONL at ``--data-path``
or the synthetic set), through the prefetching data pipeline (on by
default; ``--no-prefetch``, ``--prefetch-depth``); the f32 or the int8
score store (``--quant-scores``), replicated or in row blocks
(``--shard-scores``, with ``--quant-wire`` for the int8 store's wire),
each with its fused kernel or its scatter form; checkpoints and a
bit-exact resume, mid-epoch
and with a pipelined held batch included (``--ckpt-dir``); int8 gradient
compression with error feedback on one device (``--grad-compression``).
The dense, MoE, SSM and hybrid families run (``--arch``). vlm and encdec
are refused at construction with the reference's reasons ("vlm needs
image embeddings", "encdec needs frame embeddings"): no source makes
their frontend stubs, and the reference's trainer runs neither (its
``lm_hidden`` asserts them); they train through ``ESEngine`` on batches
that carry ``image_embeds`` or ``frames``.

``--shard-scores`` splits the store into one row block per device of the
run (``distributed.sharding.local_devices``: every CUDA device, or the one
CPU), as the reference splits it over every device of its mesh. With
fewer than two blocks, or a store that the blocks do not divide, it warns
as the reference does and the store stays replicated; the summary's
``score_store_sharded`` says which. The model stays on ``--device``: the
reference's trainer shards only the store.

Preemption and stragglers (``distributed/fault_tolerance.py``), as the
reference's trainer: SIGTERM or SIGINT only sets a flag, and after the
step in flight ``_record`` prints ``[preempt] checkpoint-and-exit``,
writes a final checkpoint (with ``--ckpt-dir``) and stops, so a run given
the same directory resumes bitwise; each step's time feeds a
``StragglerMonitor``, whose flagged steps the summary counts
(``straggler_reports``).
``--device`` (default ``cuda``) and ``--seed`` are the port's own: without
a GPU the default device raises, and the CPU runs only when asked for.

Hosts: ``--num-hosts``/``--host-id`` give this process's slice of every
global meta-batch. Left unset they come from ``torch.distributed`` when a
process group is initialised, else one host (the reference reads
``jax.process_count()``/``process_index()``).

Growth (the online service, ``launch/service.py``): ``grow(n_new,
epoch)`` admits rows the source (a ``StreamingSource``) has appended: the
store grows now, the sampler walks them from the next epoch. Hooks in
``step_hooks`` run as ``hook(trainer, epoch)`` after each trained step,
after its loss was read (a device sync), and before the next batch is
taken. A checkpoint of a grown run resumes: the store is grown to the
manifest's last population before the state is read.

The training path's memory knobs: the model config's ``remat_policy`` and
``attn_chunk_q``, and ``ESConfig.seq_chunk`` at its default of 1,024 (the
reference's trainer passes 0, which turns the cross-entropy's chunks
off).

Set-level pruning runs on the host at an epoch's start, inside the
annealing window (``_prune_for_epoch``): the engine's cadence decides
whether to re-prune, the store's snapshot (one device → host copy) and
``core/pruning.py`` give the kept-set and InfoBatch's grad scales from
``np.random.default_rng((seed, epoch, 17))``, and the pipeline installs
them. An epoch over a kept-set runs fewer steps; the learning-rate and
scoring schedules are sized from the pruned horizon
(``planned_steps_per_epoch``). A packed source prunes documents inside
rows, so its step count does not change.

A checkpoint holds the whole ``TrainState`` (``ESEngine.state_dict``) and
a manifest whose ``metadata`` has the reference's keys: the counters, the
store's spec, the data cursor (with ``held`` for a pipelined carry and
the kept-set's digest) and the cadence; its extras hold the kept-set, the
grad scales and ``prev_epoch_losses``. A mid-epoch resume keeps the
restored kept-set and does not re-prune.

The epoch loop is the reference's: a session per epoch (pipelined primes
folded into ``scoring_steps_total``, ``finish`` training the held batch),
a stream of device batches per epoch, and a step's time taken from the
end of the previous step, so it includes the wait for the batch. The
port reads the step's loss (a device sync) before it takes the time, so
a step's time covers its device work. The learning-rate schedule,
annealing window and the JSON summary (``final_loss``, ``steps``,
``bp_samples_total``, ``scoring_steps_total``, ``wall_time``) follow the
reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..core.annealing import AnnealSchedule
from ..core.engine import (CadenceConfig, ESConfig, ESEngine,
                           init_train_state)
from ..core.frequency import make_schedule
from ..core.scores import make_store
from ..data.pipeline import (DataPipeline, Prefetcher, SyncStream,
                             get_source, make_placer)
from ..data.pipeline.sources import SOURCES
from ..distributed import sharding
from ..distributed.fault_tolerance import PreemptionHandler, StragglerMonitor
from ..models.transformer import MEMORY_NEEDED, lm_per_sample_loss
from ..optim.adamw import OptConfig
from ..optim.schedule import get_schedule


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "llama3-8b"
    smoke: bool = True
    method: str = "es"            # es | eswp | loss | order | baseline |
    #                               infobatch | ucb | ka | random
    epochs: int = 4
    meta_batch: int = 32
    minibatch: int = 8
    beta1: float = 0.2
    beta2: float = 0.9
    pruning_ratio: float = 0.2    # set-level: share of samples pruned
    anneal_ratio: float = 0.05
    n_samples: int = 1024
    seq_len: int = 64
    lr: float = 1e-3
    schedule: str = "cosine"
    optimizer: str = "adamw"
    seed: int = 0
    pipelined: bool = False       # score batch t+1 while training batch t
    score_every: int = 1          # k: scoring forward every k-th step
    freq_schedule: str = "fixed"  # fixed | warmup | adaptive | drift
    gain_floor: float = 0.5       # adaptive: retained Thm. 3.2 passband
    drift_target: float = 0.05    # drift: relative |ds| the servo tracks
    prune_cadence: str = "epoch"  # epoch | drift (set-level re-prune gate)
    prune_max_interval: int = 4   # drift prune cadence: epochs backstop
    fused_scores: bool = True     # score kernel vs the scatter form
    drop_last: bool = True
    log_path: Optional[str] = None
    max_steps: Optional[int] = None
    device: str = "cuda"
    quant_scores: bool = False    # int8 score store
    quant_block: int = 1024       # rows per int8 scale
    source: str = "synthetic"     # synthetic | tokens | sharded | sft |
    #                               packed
    data_path: Optional[str] = None  # bin / glob / jsonl of a file source
    host_id: Optional[int] = None    # default: the process group's rank
    num_hosts: Optional[int] = None  # default: its world size, else 1
    pack: bool = False            # packed documents (source "packed")
    max_segments: int = 4         # documents per packed row
    prefetch: bool = True         # build + copy batch t+1 during step t
    prefetch_depth: int = 2
    ckpt_dir: Optional[str] = None
    ckpt_every_steps: int = 50
    grad_compression: bool = False   # int8 EF gradient compression
    shard_scores: bool = False    # the store in row blocks over the devices
    quant_wire: bool = False      # int8 cross-block gather/select payloads


SET_LEVEL = {"eswp", "infobatch", "ucb", "ka", "random"}
BATCH_LEVEL = {"es", "eswp", "loss", "order"}
METHODS = ("es", "eswp", "loss", "order", "baseline", "infobatch", "ucb",
           "ka", "random")


def _check_supported(tc: TrainerConfig) -> None:
    if tc.source not in SOURCES:
        raise ValueError(f"unknown --source {tc.source!r}; one of "
                         f"{SOURCES}")
    if tc.method not in METHODS:
        raise NotImplementedError(
            f"method {tc.method!r} is not ported yet; the PyTorch port runs "
            f"{METHODS}")


def _hosts(tc: TrainerConfig) -> Tuple[int, int]:
    """(host_id, num_hosts): the config's, else the process group's rank
    and world size, else one host."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    host_id = tc.host_id if tc.host_id is not None \
        else (dist.get_rank() if live else 0)
    num_hosts = tc.num_hosts if tc.num_hosts is not None \
        else (dist.get_world_size() if live else 1)
    return host_id, num_hosts


class Trainer:
    """ES trainer: the model on one device, the score store on it or in
    row blocks over the run's devices (``--shard-scores``).

    ``model_cfg`` overrides the ``--arch`` config; ``init_params`` (the
    port's parameter dict, e.g. from ``bridge.params_from_jax``) replaces
    the random init; ``source`` replaces the one ``tc.source`` names (the
    service passes a ``StreamingSource``). With a packed source the ES
    identity (score rows, selection) is the DOCUMENT: the store holds
    ``n_docs`` rows while the sampler walks packed rows.
    """

    def __init__(self, tc: TrainerConfig,
                 model_cfg: Optional[ModelConfig] = None,
                 init_params: Optional[Dict] = None, source=None):
        _check_supported(tc)
        if tc.pack and tc.source != "packed":
            tc = dataclasses.replace(tc, source="packed")
        self.tc = tc
        self.device = torch.device(tc.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' requested but no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model_cfg = model_cfg or (
            get_smoke_config(tc.arch) if tc.smoke else get_config(tc.arch))
        if self.model_cfg.family in MEMORY_NEEDED:
            raise ValueError(
                f"{MEMORY_NEEDED[self.model_cfg.family]}: no source of the "
                f"trainer makes them (the reference's trainer runs no "
                f"{self.model_cfg.family!r} model); train it through "
                f"ESEngine on batches that carry them")
        self.preempt = PreemptionHandler().install()
        self.straggler = StragglerMonitor()
        if source is None:
            source = get_source(tc.source, path=tc.data_path,
                                n_samples=tc.n_samples, seq_len=tc.seq_len,
                                vocab_size=min(self.model_cfg.vocab_size,
                                               64),
                                seed=tc.seed, max_segments=tc.max_segments)
        self.source = source
        self.host_id, self.num_hosts = _hosts(tc)
        self._placer = make_placer(self.device)
        self.pipeline = DataPipeline(self.source, tc.meta_batch,
                                     seed=tc.seed, host_id=self.host_id,
                                     num_hosts=self.num_hosts,
                                     drop_last=tc.drop_last,
                                     prefetch=tc.prefetch,
                                     depth=tc.prefetch_depth,
                                     place=self._placer)
        self.doc_level = self.pipeline.doc_level
        self.n_train = self.source.n_docs if self.doc_level \
            else len(self.source)
        # the underlying dataset and the sampler, for introspection
        self.ds = getattr(self.source, "ds", self.source)
        self.sampler = self.pipeline.sampler

        beta1, beta2 = tc.beta1, tc.beta2
        if tc.method == "loss":
            beta1 = beta2 = 0.0            # paper Eq. (2.3)
        if tc.method == "eswp":
            beta2 = min(beta2, 0.8)        # the paper's ESWP default
        # set-level-only methods take baseline steps over their kept-set
        self.sel_method = tc.method if tc.method in BATCH_LEVEL \
            else "baseline"
        minibatch = tc.minibatch if tc.method in BATCH_LEVEL \
            else tc.meta_batch
        self.es_cfg = ESConfig(
            method=self.sel_method if self.sel_method != "baseline"
            else "es",
            beta1=beta1, beta2=beta2, minibatch=minibatch,
            n_train=self.n_train, fused_scores=tc.fused_scores)
        self.opt_cfg = OptConfig(kind=tc.optimizer, lr=tc.lr,
                                 state_dtype=self.model_cfg.optimizer_dtype,
                                 compress_grads=tc.grad_compression)
        self.anneal = AnnealSchedule.from_ratio(tc.epochs, tc.anneal_ratio)
        # an epoch over a kept-set runs fewer steps: the schedules' horizon
        # is the planned per-epoch count, pruned where pruning is active
        steps_first = self.planned_steps_per_epoch(0)
        total_steps = sum(self.planned_steps_per_epoch(pruned=p) * c
                          for p, c in self._epoch_counts())
        self.schedule = get_schedule(tc.schedule, max(total_steps, 1),
                                     warmup_steps=steps_first // 2)
        self.freq = make_schedule(tc.freq_schedule, tc.score_every,
                                  steps_per_epoch=steps_first,
                                  beta1=beta1, beta2=beta2,
                                  gain_floor=tc.gain_floor)
        self.score_sharding = self._make_score_sharding() \
            if tc.shard_scores else None
        self.store = make_store(self.score_sharding,
                                quantize=tc.quant_scores,
                                block=tc.quant_block, wire=tc.quant_wire)
        cadence = CadenceConfig(
            kind="drift" if tc.freq_schedule == "drift" else "static",
            target=tc.drift_target, k_cap=self.freq.target_period,
            prune_kind=tc.prune_cadence,
            prune_max_interval=tc.prune_max_interval)
        self.engine = ESEngine(self.model_cfg, self.es_cfg, self.opt_cfg,
                               self.schedule, freq=self.freq,
                               cadence=cadence, store=self.store)
        self.state = init_train_state(self.model_cfg, self.es_cfg,
                                      self.opt_cfg, tc.seed, self.device,
                                      params=init_params, store=self.store,
                                      meta_batch=tc.meta_batch)
        self.ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
        # hook(trainer, epoch) after every trained step (the service polls
        # admission here)
        self.step_hooks: list = []
        self.metrics_log: list = []
        self.prune_events: list = []
        self.epoch_log: list = []
        self.global_step = 0
        self.bp_samples_total = 0.0
        self.scoring_steps_total = 0.0
        self.prev_epoch_losses: Optional[np.ndarray] = None
        self.epochs_since_prune = 0
        # True once this run holds a kept-set (pruned, or restored)
        self._pruned_in_process = False
        self._cur_sess = None
        self._epoch_consumed = 0       # meta-batches taken this epoch
        self.start_epoch = 0
        self._resume_step = 0          # consumed meta-batches mid-epoch
        self._resume_held = False      # pipelined carry at checkpoint time
        if self.ckpt and self.ckpt.latest_step() is not None:
            self._resume()

    def _steps_for(self, n: int) -> int:
        mb = self.tc.meta_batch
        return max(1, n // mb if self.tc.drop_last else -(-n // mb))

    def planned_steps_per_epoch(self, epoch: int = 0,
                                pruned: Optional[bool] = None) -> int:
        """Meta-batches of ``epoch`` as planned at init: over the kept-set
        size for a set-level method inside the annealing window, over
        every row outside it. A packed source counts rows, and prunes
        documents inside them, so its count never shrinks. The actual
        count is re-read from the sampler at each epoch's start
        (``epoch_log``)."""
        if pruned is None:
            pruned = (self.tc.method in SET_LEVEL
                      and self.anneal.selection_active(epoch))
        n = len(self.source)
        if pruned and not self.doc_level:
            n = max(1, int(round((1.0 - self.tc.pruning_ratio) * n)))
        return self._steps_for(n)

    def _epoch_counts(self):
        """[(pruned?, number of epochs)] over the whole run."""
        e = self.tc.epochs
        if self.tc.method not in SET_LEVEL:
            return [(False, e)]
        lo, hi = self.anneal.start_epochs, e - self.anneal.end_epochs
        active = max(0, hi - lo)
        return [(True, active), (False, e - active)]

    def _make_score_sharding(self):
        """One row block per device of the run, or None (with the
        reference's warnings) when that is fewer than two blocks or the
        blocks do not divide the store."""
        ss = sharding.score_store_sharding(
            sharding.local_devices(self.device))
        if ss is None:
            warnings.warn("--shard-scores: single device, store stays "
                          "replicated", stacklevel=2)
        elif self.n_train % ss.n_shards != 0:
            warnings.warn(f"--shard-scores: n_train={self.n_train} not "
                          f"divisible by {ss.n_shards} devices, store "
                          f"stays replicated", stacklevel=2)
            return None
        return ss

    def _place(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One host batch on the trainer's device, ready to read."""
        return self._placer.ready(self._placer(host))

    def _grow_store(self, n_new: int) -> None:
        """Grow the store, the engine's config and the state by ``n_new``
        rows (old rows bitwise, new ones at the 1/n' prior)."""
        self.store, self.state.scores = self.store.grow(self.state.scores,
                                                        n_new)
        self.engine.store = self.store
        self.n_train += n_new
        self.es_cfg = dataclasses.replace(self.es_cfg, n_train=self.n_train)
        self.engine.es_cfg = self.es_cfg
        if self.prev_epoch_losses is not None:
            # 0.0: KA's move-back rule re-admits rows without a previous
            # epoch's loss
            self.prev_epoch_losses = np.concatenate(
                [self.prev_epoch_losses, np.zeros(n_new, np.float32)])

    def grow(self, n_new: int, epoch: int) -> None:
        """Admit ``n_new`` rows the source has already appended: the store
        grows now, the sampler walks them from epoch ``epoch + 1`` (the
        current epoch's permutation stays). The pipeline grows first: it
        checks that the source holds the rows, so a missing ``append``
        leaves the run untouched."""
        self.pipeline.grow(n_new, epoch)
        self._grow_store(n_new)

    def _resume(self) -> None:
        """Restore the latest checkpoint: the state, the counters and the
        data cursor (mid-epoch position, pipelined carry, growth)."""
        step = self.ckpt.latest_step()
        md = self.ckpt.manifest(step)["metadata"]
        cur = md.get("data")
        if cur is not None:     # checked before the state is read
            extras = self.ckpt.extras(step)
            self.pipeline.load_state(extras, cur)
            # a grown run: extend the template store to the checkpoint's
            # population before the state is read into it
            growth = cur.get("growth") or []
            if growth and int(growth[-1][1]) > self.n_train:
                self._grow_store(int(growth[-1][1]) - self.n_train)
        self.state = self.engine.load_state_dict(
            self.state, self.ckpt.restore(
                self.engine.state_dict(self.state), step,
                partition=self.store.checkpoint_partition()))
        self.global_step = md.get("global_step", step)
        self.start_epoch = md.get("epoch", 0)
        self.bp_samples_total = md.get("bp_samples_total", 0.0)
        self.scoring_steps_total = md.get("scoring_steps_total", 0.0)
        self.epochs_since_prune = md.get("epochs_since_prune", 0)
        if cur is not None:
            if "prev_epoch_losses" in extras:
                self.prev_epoch_losses = extras["prev_epoch_losses"]
            self._pruned_in_process = self.pipeline.has_pruning
            self._resume_step = cur.get("step", 0)
            self._resume_held = cur.get("held", False)
            # a cursor at the epoch's end with no carry: the epoch ended,
            # so resume at the next one
            if (not self._resume_held and self._resume_step
                    >= self.pipeline.steps_per_epoch(self.start_epoch)):
                self.start_epoch += 1
                self._resume_step = 0
        print(f"[resume] step={self.global_step} epoch={self.start_epoch}"
              f" epoch_step={self._resume_step}"
              f"{' +held' if self._resume_held else ''}")

    def _checkpoint(self, epoch: int, final: bool = False) -> None:
        """Save the state with the reference's manifest metadata; the last
        checkpoint of a run is written before ``train`` returns, the others
        on a thread."""
        if not self.ckpt:
            return
        tree = self.engine.state_dict(self.state)
        cad = self.state.cadence
        cursor = self.pipeline.cursor(epoch, self._epoch_consumed)
        cursor["held"] = bool(self._cur_sess is not None
                              and self._cur_sess.has_held)
        md = {"global_step": self.global_step, "epoch": epoch,
              "bp_samples_total": self.bp_samples_total,
              "scoring_steps_total": self.scoring_steps_total,
              "epochs_since_prune": self.epochs_since_prune,
              "method": self.tc.method,
              "score_store": self.store.checkpoint_spec(),
              "data": cursor,
              # readable copy; the values restored are the state's
              "cadence": {"kind": self.engine.cadence.kind,
                          "period": int(cad.period),
                          "drift_s": float(cad.drift_s),
                          "drift_w": float(cad.drift_w),
                          "since_prune": float(cad.since_prune)}}
        extras = self.pipeline.state_arrays()
        if self.prev_epoch_losses is not None:
            extras["prev_epoch_losses"] = self.prev_epoch_losses
        save = self.ckpt.save if final else self.ckpt.save_async
        save(tree, self.global_step, md, extras,
             partition=self.store.checkpoint_partition())

    def _prune_for_epoch(self, epoch: int) -> None:
        """Set-level selection before ``epoch``, gated by the engine's
        prune cadence. Outside the annealing window (or for a batch-level
        method) every sample is back in the walk."""
        if self.tc.method not in SET_LEVEL \
                or not self.anneal.selection_active(epoch):
            self.pipeline.apply_pruning(None)
            return
        # counts this epoch, so prune_max_interval = N bounds the gap
        # between prunes at N epochs
        self.epochs_since_prune += 1
        # a run that holds no kept-set (fresh, or resumed from a checkpoint
        # without one) must prune: skipping would keep every sample
        if not self._pruned_in_process:
            fired, reason = True, "first-prune"
        else:
            fired, reason = self.engine.prune_decision(
                self.state.cadence, self.epochs_since_prune)
        self.prune_events.append({
            "epoch": epoch, "fired": fired, "reason": reason,
            "epochs_since_prune": self.epochs_since_prune,
            "since_prune_drift": float(self.state.cadence.since_prune)})
        if not fired:
            return                          # the kept-set carries over
        rng = np.random.default_rng((self.tc.seed, epoch, 17))
        res, s_host = self.store.prune_epoch(
            self.tc.method, rng, self.state.scores,
            prev_losses=self.prev_epoch_losses,
            ratio=self.tc.pruning_ratio)
        self.pipeline.apply_pruning(res.kept, res.grad_scale)
        self.prev_epoch_losses = s_host.copy()
        self.epochs_since_prune = 0
        self._pruned_in_process = True
        self.state = self.engine.reset_prune_drift(self.state)

    def _record(self, epoch: int, m: Dict[str, Any], dur: float,
                data_wait: float) -> bool:
        """Book one trained step (``dur`` and ``data_wait`` in seconds);
        True when training should stop: at the step cap, or on a
        preemption signal, after a final checkpoint."""
        self.straggler.record(self.global_step, dur)
        self.global_step += 1
        self.bp_samples_total += float(m["bp_samples"])
        scored = float(m.get("scored", 1.0))
        self.scoring_steps_total += scored
        self.metrics_log.append({
            "step": self.global_step, "epoch": epoch,
            "loss": float(m["loss"]), "scored": scored,
            "bp_samples_total": self.bp_samples_total,
            # the age of this epoch's kept-set in epochs (0: pruned
            # before this epoch)
            "epochs_since_prune": self.epochs_since_prune,
            "step_time": dur, "data_wait": data_wait})
        if self.ckpt and self.global_step % self.tc.ckpt_every_steps == 0:
            self._checkpoint(epoch)
        if self.preempt.preemption_requested:
            print("[preempt] checkpoint-and-exit")
            self._checkpoint(epoch, final=True)
            return True
        return bool(self.tc.max_steps
                    and self.global_step >= self.tc.max_steps)

    def train(self) -> Dict[str, Any]:
        tc = self.tc
        t_start = time.time()
        stop = False
        epoch = self.start_epoch
        for epoch in range(self.start_epoch, tc.epochs):
            resumed = epoch == self.start_epoch
            start_step = self._resume_step if resumed else 0
            resume_held = resumed and self._resume_held
            # between epochs, with no stream open: a packed source's
            # kept-set is what the next epoch's prefetch worker reads.
            # A mid-epoch resume keeps the restored kept-set: re-pruning
            # would read mid-epoch scores and leave the uninterrupted run
            if start_step == 0 and not resume_held:
                self._prune_for_epoch(epoch)
            selection_on = (self.anneal.selection_active(epoch)
                            and self.sel_method != "baseline")
            self.epoch_log.append({
                "epoch": epoch,
                "steps_per_epoch": self.pipeline.steps_per_epoch(epoch),
                "selection_on": selection_on})
            sess = self.engine.session(selection_on, tc.pipelined)
            self._cur_sess = sess
            self._epoch_consumed = start_step
            if resume_held and start_step > 0 and sess.pipelined:
                # the checkpointed carry: the restored pending_w was scored
                # for this batch, so no prime runs
                sess.resume_held(self._place(
                    self.pipeline.batch_at(epoch, start_step - 1)))
            primes_folded = 0
            waited = 0.0           # consumer stall since the last record
            with self.pipeline.epoch(epoch, start_step) as stream:
                t0 = time.perf_counter()
                while True:
                    tw = time.perf_counter()
                    jb = next(stream, None)
                    waited += time.perf_counter() - tw
                    if jb is None:
                        break
                    self._epoch_consumed += 1
                    self.state, m = sess.step(self.state, jb)
                    if m is None:   # pipelined prime: batch held
                        self.scoring_steps_total += \
                            sess.scoring_primes - primes_folded
                        primes_folded = sess.scoring_primes
                        continue
                    float(m["loss"])            # waits for the device
                    stop = self._record(epoch, m, time.perf_counter() - t0,
                                        waited)
                    for hook in self.step_hooks:
                        hook(self, epoch)
                    waited = 0.0
                    t0 = time.perf_counter()
                    if stop:
                        break
            if stop:
                break
            # train the held batch so the epoch's last one is not dropped
            t0 = time.perf_counter()
            self.state, m = sess.finish(self.state)
            if m is not None:
                float(m["loss"])
                if self._record(epoch, m, time.perf_counter() - t0, 0.0):
                    break
        self._checkpoint(epoch, final=True)
        self._cur_sess = None
        if self.ckpt:
            self.ckpt.wait()
        out = {
            "final_loss": self.metrics_log[-1]["loss"]
            if self.metrics_log else float("nan"),
            "steps": self.global_step,
            "bp_samples_total": self.bp_samples_total,
            "scoring_steps_total": self.scoring_steps_total,
            "wall_time": time.time() - t_start,
            "straggler_reports": len(self.straggler.reports),
            "score_store_sharded": self.score_sharding is not None,
            "device": str(self.device),
            "prune_events": self.prune_events,
            "epoch_log": self.epoch_log,
            "metrics": self.metrics_log,
        }
        if tc.log_path:
            Path(tc.log_path).parent.mkdir(parents=True, exist_ok=True)
            Path(tc.log_path).write_text(json.dumps(out, indent=1))
        return out

    def eval_mean_loss(self, n: int = 256, batch: int = 32) -> float:
        """Mean per-sample loss over the first ``n`` samples, no selection:
        the no-grad scoring forward (flash and xent kernels) on batches
        padded to one shape and masked, fed through the same stream class
        as training."""
        n = min(n, len(self.source))

        def host_batches():
            for lo in range(0, n, batch):
                ids = np.arange(lo, min(lo + batch, n))
                mask = np.ones(batch, np.float32)
                if len(ids) < batch:      # pad: one shape
                    mask[len(ids):] = 0.0
                    ids = np.concatenate(
                        [ids, np.full(batch - len(ids), ids[-1])])
                eb = self.source.batch(ids)
                eb["eval_mask"] = mask
                yield eb

        stream_cls = Prefetcher if self.tc.prefetch else SyncStream
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        with stream_cls(host_batches(), place=self._placer) as stream, \
                torch.no_grad():
            for jb in stream:
                mask = jb.pop("eval_mask")
                ps, _ = lm_per_sample_loss(self.model_cfg, self.state.params,
                                           jb, scoring=True)
                total += torch.sum(ps * mask).double()
                count += torch.sum(mask).double()
        return float(total) / max(float(count), 1.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Evolved Sampling trainer (PyTorch port)")
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--method", default="es")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--meta-batch", type=int, default=32)
    ap.add_argument("--minibatch", type=int, default=8)
    ap.add_argument("--n-samples", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--pipelined", action="store_true",
                    help="score meta-batch t+1 while training on t (on "
                    "CUDA, on a second stream)")
    ap.add_argument("--score-every", type=int, default=1,
                    help="k: run the scoring forward every k-th step "
                    "(adaptive/drift: the period cap, 64 when left at 1)")
    ap.add_argument("--freq-schedule", default="fixed",
                    choices=["fixed", "warmup", "adaptive", "drift"],
                    help="scoring-frequency schedule; drift servoes the "
                    "period from the observed score-store deltas")
    ap.add_argument("--gain-floor", type=float, default=0.5,
                    help="adaptive schedule: retained Thm. 3.2 passband")
    ap.add_argument("--drift-target", type=float, default=0.05,
                    help="drift schedule: relative |ds| the servo tracks")
    ap.add_argument("--prune-cadence", default="epoch",
                    choices=["epoch", "drift"],
                    help="set-level re-prune gate: every epoch, or when "
                    "the observed score drift re-arms it")
    ap.add_argument("--no-fused-scores", dest="fused_scores",
                    action="store_false",
                    help="scatter score update instead of the score kernel")
    ap.add_argument("--keep-partial", dest="drop_last", action="store_false",
                    help="train the partial final meta-batch of each epoch")
    ap.add_argument("--log", dest="log_path", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint every 50 steps and at the end; a run "
                    "given a directory that holds one resumes from it")
    ap.add_argument("--quant-scores", action="store_true",
                    help="int8 score store (per-block scales + residual "
                    "ring)")
    ap.add_argument("--quant-block", type=int, default=1024,
                    help="rows per int8 scale")
    ap.add_argument("--source", default="synthetic", choices=SOURCES,
                    help="in-memory synthetic LM, a memory-mapped token "
                    "file, token files (glob), prompt/response pairs with "
                    "response-only labels, or packed synthetic documents")
    ap.add_argument("--data-path", default=None,
                    help="tokens: .bin path; sharded: glob pattern; sft: "
                    "JSONL path (omit for the synthetic SFT set)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this host's slice of each global meta-batch "
                    "(default: the process group's rank, else 0)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="hosts sharing each global meta-batch (default: "
                    "the process group's world size, else 1)")
    ap.add_argument("--pack", action="store_true",
                    help="packed documents, token-level ES (--n-samples "
                    "counts documents)")
    ap.add_argument("--max-segments", type=int, default=4,
                    help="documents per packed row")
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    help="build and copy each batch inline instead of on "
                    "a background thread")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="batches the background thread runs ahead")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 quantize -> dequantize of the gradients "
                    "with error feedback before each optimizer step")
    ap.add_argument("--shard-scores", action="store_true",
                    help="the score store in row blocks, one per device of "
                    "the run (replicated, with a warning, on one device)")
    ap.add_argument("--quant-wire", action="store_true",
                    help="int8 payloads on the cross-block gather and "
                    "selection of the sharded int8 store (lossy by one "
                    "grid step)")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    tc = TrainerConfig(**{k: v for k, v in vars(args).items()
                          if k in fields})
    out = Trainer(tc).train()
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("metrics", "epoch_log")}, indent=1))
    return out


if __name__ == "__main__":
    main()
