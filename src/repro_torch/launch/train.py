"""Serial and packed ES trainer and its CLI (counterpart of
``repro/launch/train.py``: ``Trainer`` :104-236 and :464-549, ``main``
:591).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --full --method es \\
        --meta-batch 32 --minibatch 8 --seq-len 512 --n-samples 1024 \\
        --max-steps 4
    # packed, token-level ES (--n-samples counts documents)
    ... --pack --max-segments 4 --meta-batch 16 --minibatch 16
    # the int8 score store
    ... --quant-scores --quant-block 1024

The flags are the JAX CLI's. What the port runs: methods ``es``, ``loss``,
``order`` and ``baseline``; a fixed scoring period (``--score-every``); the
synthetic source, or the packed synthetic documents (``--pack``, ``--source
packed``) with a synchronous data path; the f32 or the replicated int8
score store (``--quant-scores``), each with its fused kernel or its
scatter form. Every other flag raises "not ported yet" when it asks for
anything but its default. ``--device`` (default ``cuda``) and ``--seed``
are the port's own: without a GPU the default device raises, and the CPU
runs only when asked for.

The learning-rate schedule, annealing window and the JSON summary
(``final_loss``, ``steps``, ``bp_samples_total``, ``scoring_steps_total``,
``wall_time``) follow the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, require_dense
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..core.annealing import AnnealSchedule
from ..core.engine import ESConfig, ESEngine, init_train_state
from ..core.frequency import FreqSchedule
from ..core.scores import make_store
from ..data.packed import PackedSource
from ..data.sampler import ESSampler
from ..data.synthetic import SyntheticConfig, SyntheticLM
from ..kernels.segsum.ops import MAX_SEGMENTS
from ..optim.adamw import OptConfig
from ..optim.schedule import get_schedule


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "llama3-8b"
    smoke: bool = True
    method: str = "es"            # es | loss | order | baseline
    epochs: int = 4
    meta_batch: int = 32
    minibatch: int = 8
    beta1: float = 0.2
    beta2: float = 0.9
    anneal_ratio: float = 0.05
    n_samples: int = 1024
    seq_len: int = 64
    lr: float = 1e-3
    schedule: str = "cosine"
    optimizer: str = "adamw"
    seed: int = 0
    score_every: int = 1          # k: scoring forward every k-th step
    freq_schedule: str = "fixed"
    fused_scores: bool = True     # score kernel vs the scatter form
    drop_last: bool = True
    log_path: Optional[str] = None
    max_steps: Optional[int] = None
    device: str = "cuda"
    quant_scores: bool = False    # int8 score store
    quant_block: int = 1024       # rows per int8 scale
    source: str = "synthetic"     # synthetic | packed
    pack: bool = False            # packed documents (source "packed")
    max_segments: int = 4         # documents per packed row
    # not ported yet: each must keep its default (see _check_supported)
    pipelined: bool = False
    gain_floor: float = 0.5
    drift_target: float = 0.05
    prune_cadence: str = "epoch"
    shard_scores: bool = False
    quant_wire: bool = False
    host_id: Optional[int] = None
    num_hosts: Optional[int] = None
    grad_compression: bool = False
    data_path: Optional[str] = None
    prefetch: bool = False        # the port's data path is synchronous
    prefetch_depth: int = 2
    ckpt_dir: Optional[str] = None


METHODS = ("es", "loss", "order", "baseline")
BATCH_LEVEL = ("es", "loss", "order")
# field -> what it would turn on; each must keep its default
_NOT_PORTED = {
    "pipelined": "--pipelined (pipelined ES on two streams)",
    "gain_floor": "--gain-floor (adaptive schedule)",
    "drift_target": "--drift-target (drift schedule)",
    "prune_cadence": "--prune-cadence (set-level pruning)",
    "shard_scores": "--shard-scores (sharded score store)",
    "quant_wire": "--quant-wire (int8 wire of the sharded store)",
    "host_id": "--host-id (multi-host data slicing)",
    "num_hosts": "--num-hosts (multi-host data slicing)",
    "grad_compression": "--grad-compression (int8 gradient wire)",
    "data_path": "--data-path (file sources)",
    "prefetch": "prefetch (the prefetching data pipeline)",
    "prefetch_depth": "--prefetch-depth (the prefetching data pipeline)",
    "ckpt_dir": "--ckpt-dir (checkpoint and resume)",
}


SOURCES = ("synthetic", "packed")


def _check_supported(tc: TrainerConfig) -> None:
    defaults = TrainerConfig()
    for field, what in _NOT_PORTED.items():
        if getattr(tc, field) != getattr(defaults, field):
            raise NotImplementedError(f"{what} is not ported yet")
    if tc.source not in SOURCES:
        raise NotImplementedError(
            f"--source {tc.source} is not ported yet; the PyTorch port runs "
            f"{SOURCES}")
    if tc.method not in METHODS:
        raise NotImplementedError(
            f"method {tc.method!r} is not ported yet; the PyTorch port runs "
            f"{METHODS}")


class Trainer:
    """Serial or packed ES trainer on one device.

    ``model_cfg`` overrides the ``--arch`` config; ``init_params`` (the
    port's parameter dict, e.g. from ``bridge.params_from_jax``) replaces
    the random init. With a packed source the ES identity (score rows,
    selection) is the DOCUMENT: the store holds ``n_docs`` rows while the
    sampler walks packed rows.
    """

    def __init__(self, tc: TrainerConfig,
                 model_cfg: Optional[ModelConfig] = None,
                 init_params: Optional[Dict] = None):
        _check_supported(tc)
        if tc.pack and tc.source != "packed":
            tc = dataclasses.replace(tc, source="packed")
        self.tc = tc
        self.device = torch.device(tc.device)
        if (self.device.type == "cuda" and tc.source == "packed"
                and tc.max_segments > MAX_SEGMENTS):
            raise ValueError(
                f"--max-segments {tc.max_segments}: the segment-sum kernel "
                f"takes at most {MAX_SEGMENTS} documents a row on CUDA")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' requested but no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model_cfg = model_cfg or (
            get_smoke_config(tc.arch) if tc.smoke else get_config(tc.arch))
        require_dense(self.model_cfg)
        vocab = min(self.model_cfg.vocab_size, 64)
        self.doc_level = tc.source == "packed"
        if self.doc_level:
            self.ds = PackedSource.synthetic(
                tc.n_samples, tc.seq_len, max_segments=tc.max_segments,
                vocab=vocab, seed=tc.seed)
            self.n_train = self.ds.n_docs
        else:
            self.ds = SyntheticLM(SyntheticConfig(
                n_samples=tc.n_samples, seq_len=tc.seq_len,
                vocab_size=vocab, seed=tc.seed))
            self.n_train = len(self.ds)
        self.sampler = ESSampler(len(self.ds), tc.meta_batch, seed=tc.seed,
                                 drop_last=tc.drop_last)

        beta1, beta2 = tc.beta1, tc.beta2
        if tc.method == "loss":
            beta1 = beta2 = 0.0            # paper Eq. (2.3)
        self.sel_method = tc.method
        minibatch = tc.minibatch if tc.method in BATCH_LEVEL \
            else tc.meta_batch
        self.es_cfg = ESConfig(
            method=tc.method if tc.method != "baseline" else "es",
            beta1=beta1, beta2=beta2, minibatch=minibatch,
            n_train=self.n_train, fused_scores=tc.fused_scores)
        self.opt_cfg = OptConfig(kind=tc.optimizer, lr=tc.lr,
                                 state_dtype=self.model_cfg.optimizer_dtype)
        self.anneal = AnnealSchedule.from_ratio(tc.epochs, tc.anneal_ratio)
        steps_first = self.planned_steps_per_epoch()
        total_steps = steps_first * tc.epochs
        self.schedule = get_schedule(tc.schedule, max(total_steps, 1),
                                     warmup_steps=steps_first // 2)
        self.freq = FreqSchedule(kind=tc.freq_schedule, k=tc.score_every)
        self.store = make_store(None, quantize=tc.quant_scores,
                                block=tc.quant_block)
        self.engine = ESEngine(self.model_cfg, self.es_cfg, self.opt_cfg,
                               self.schedule, freq=self.freq,
                               store=self.store)
        self.state = init_train_state(self.model_cfg, self.es_cfg,
                                      self.opt_cfg, tc.seed, self.device,
                                      params=init_params, store=self.store)
        self.metrics_log: list = []
        self.global_step = 0
        self.bp_samples_total = 0.0
        self.scoring_steps_total = 0.0

    def planned_steps_per_epoch(self) -> int:
        """Meta-batches per epoch; a packed source counts rows."""
        n, mb = len(self.ds), self.tc.meta_batch
        return max(1, n // mb if self.tc.drop_last else -(-n // mb))

    def _place(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    def _record(self, epoch: int, m: Dict[str, Any], loss: float,
                dur: float) -> bool:
        """Book one trained step; True when training should stop."""
        self.global_step += 1
        self.bp_samples_total += float(m["bp_samples"])
        scored = float(m.get("scored", 1.0))
        self.scoring_steps_total += scored
        self.metrics_log.append({
            "step": self.global_step, "epoch": epoch, "loss": loss,
            "scored": scored, "bp_samples_total": self.bp_samples_total,
            "step_time": dur})
        return bool(self.tc.max_steps
                    and self.global_step >= self.tc.max_steps)

    def train(self) -> Dict[str, Any]:
        tc = self.tc
        t_start = time.time()
        stop = False
        for epoch in range(tc.epochs):
            selection_on = (self.anneal.selection_active(epoch)
                            and self.sel_method != "baseline")
            eng = self.engine
            if self.doc_level:
                # scoring rides the packed training forward: no schedule
                step_fn = eng.packed_step if selection_on \
                    else eng.packed_baseline_step
            else:
                step_fn = eng.scheduled_step if selection_on \
                    else eng.baseline_step
            for _, ids in self.sampler.epoch_id_stream(epoch):
                t0 = time.time()
                batch = self._place(self.ds.batch(ids))
                self.state, m = step_fn(self.state, batch)
                loss = float(m["loss"])      # waits for the device
                stop = self._record(epoch, m, loss, time.time() - t0)
                if stop:
                    break
            if stop:
                break
        out = {
            "final_loss": self.metrics_log[-1]["loss"]
            if self.metrics_log else float("nan"),
            "steps": self.global_step,
            "bp_samples_total": self.bp_samples_total,
            "scoring_steps_total": self.scoring_steps_total,
            "wall_time": time.time() - t_start,
            "device": str(self.device),
            "metrics": self.metrics_log,
        }
        if tc.log_path:
            Path(tc.log_path).parent.mkdir(parents=True, exist_ok=True)
            Path(tc.log_path).write_text(json.dumps(out, indent=1))
        return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serial Evolved Sampling trainer (PyTorch port)")
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
    ap.add_argument("--score-every", type=int, default=1,
                    help="k: run the scoring forward every k-th step")
    ap.add_argument("--freq-schedule", default="fixed",
                    choices=["fixed", "warmup", "adaptive", "drift"],
                    help="scoring-frequency schedule; the port runs fixed")
    ap.add_argument("--no-fused-scores", dest="fused_scores",
                    action="store_false",
                    help="scatter score update instead of the score kernel")
    ap.add_argument("--keep-partial", dest="drop_last", action="store_false",
                    help="train the partial final meta-batch of each epoch")
    ap.add_argument("--log", dest="log_path", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--quant-scores", action="store_true",
                    help="int8 score store (per-block scales + residual "
                    "ring)")
    ap.add_argument("--quant-block", type=int, default=1024,
                    help="rows per int8 scale")
    ap.add_argument("--source", default="synthetic",
                    help="synthetic or packed (the port's two sources)")
    ap.add_argument("--pack", action="store_true",
                    help="packed documents, token-level ES (--n-samples "
                    "counts documents)")
    ap.add_argument("--max-segments", type=int, default=4,
                    help="documents per packed row")
    # flags of the JAX CLI that the port does not run yet: accepted, and
    # they raise "not ported yet" unless left at their defaults
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--gain-floor", type=float, default=0.5)
    ap.add_argument("--drift-target", type=float, default=0.05)
    ap.add_argument("--prune-cadence", default="epoch")
    ap.add_argument("--shard-scores", action="store_true")
    ap.add_argument("--quant-wire", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    default=False, help="the port's data path is "
                    "synchronous already")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    tc = TrainerConfig(**{k: v for k, v in vars(args).items()
                          if k in fields})
    out = Trainer(tc).train()
    print(json.dumps({k: v for k, v in out.items()
                      if k != "metrics"}, indent=1))
    return out


if __name__ == "__main__":
    main()
