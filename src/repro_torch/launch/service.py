"""Online ES scoring service: training continues over a growing dataset
(counterpart of ``repro/launch/service.py``).

    submit -> admission (Eq. (3.1) filter on the live weights)
           -> StreamingSource.append + Trainer.grow (store and sampler)
           -> the next epoch walks the admitted rows
           -> decode served from the live training weights

The service rides the trainer's step hooks: after each trained step it
polls the ``AdmissionController``; a due drain scores its candidates with
the no-grad scoring forward on the current parameters (the flash and
xent kernels on the card), admits those whose would-be weight clears
``tau`` times the store's mean weight, appends them to the source, grows
the store and sampler, and installs the measured losses as the rows'
first Eq. (3.1) update (the score-update kernel, or the int8 store's
three). The decode ``Server`` reads the trainer's parameter tensors
themselves, which AdamW updates in place. Pull-driven: no thread but the
data prefetcher's.

    python -m repro_torch.launch.service --device cpu --submit-every 2 \\
        --submit-batch 4          # smoke config on the CPU
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from ..configs.registry import get_smoke_config, get_config
from ..data.pipeline import (AdmissionController, StreamingSource,
                             SyntheticSource, es_admission_filter)
from ..data.synthetic import SyntheticConfig, SyntheticLM
from ..models.transformer import lm_per_sample_loss
from .serve import Server
from .train import Trainer, TrainerConfig


class ScoringService:
    """A ``Trainer`` over a ``StreamingSource``, an ``AdmissionController``
    and a live-weight ``Server``. ``tau`` is the admission threshold
    against the store's mean weight: 0 admits everything, 1 admits
    samples at least as valuable as the population's average."""

    def __init__(self, trainer: Trainer, *, tau: float = 1.0,
                 max_batch: int = 16, max_delay_s: float = 0.05,
                 serve: bool = True):
        if not isinstance(trainer.source, StreamingSource):
            raise ValueError(
                "ScoringService needs a Trainer over a StreamingSource "
                "(wrap the source before building the trainer so the "
                "sampler and store sizes start from the base corpus)")
        self.trainer = trainer
        self.source: StreamingSource = trainer.source
        self.tau = float(tau)
        self.max_batch = int(max_batch)
        self.admission = AdmissionController(
            self._score_candidates, self._filter, max_batch=max_batch,
            max_delay_s=max_delay_s)
        self.server = Server(trainer.model_cfg, device=trainer.device,
                             params=trainer.state.params) if serve else None
        self.admit_log: List[Dict[str, Any]] = []
        self._cur_epoch = 0
        trainer.step_hooks.append(self._on_step)

    def _score_candidates(self, tokens: np.ndarray,
                          labels: np.ndarray) -> np.ndarray:
        """Per-sample losses on the current parameters, the batch padded
        to ``max_batch`` rows (one shape for every drain)."""
        m = len(tokens)
        pad = self.max_batch - m
        if pad > 0:
            tokens = np.concatenate(
                [tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
            labels = np.concatenate(
                [labels, np.full((pad, labels.shape[1]), -1, np.int32)])
        dev = self.trainer.device
        batch = {"tokens": torch.as_tensor(tokens, device=dev),
                 "labels": torch.as_tensor(labels, device=dev)}
        with torch.no_grad():
            ps, _ = lm_per_sample_loss(self.trainer.model_cfg,
                                       self.trainer.state.params, batch,
                                       scoring=True, seq_chunk=0)
        return ps.cpu().numpy()[:m]

    def _filter(self, losses: np.ndarray) -> np.ndarray:
        """Eq. (3.1) against the store's snapshot (its mean s and w)."""
        snap = self.trainer.store.prune_snapshot(self.trainer.state.scores)
        s_ref = float(np.concatenate(snap.losses).mean())
        w_ref = float(np.concatenate(snap.weights).mean())
        return es_admission_filter(losses, s_ref=s_ref, w_ref=w_ref,
                                   beta1=self.trainer.es_cfg.beta1,
                                   tau=self.tau)

    def submit(self, tokens: np.ndarray, labels: np.ndarray) -> None:
        """Queue candidate rows; they are scored at the next due poll."""
        self.admission.submit(tokens, labels)

    def decode(self, prompts: np.ndarray, gen_len: int,
               temperature: float = 0.0) -> np.ndarray:
        """Generate from the live training weights."""
        if self.server is None:
            raise RuntimeError("service built with serve=False")
        return self.server.generate(prompts, gen_len, temperature)

    def flush(self) -> int:
        """Drain every pending candidate now; returns the rows admitted."""
        total = 0
        while len(self.admission):
            total += self._apply(self.admission.flush())
        return total

    def _on_step(self, trainer: Trainer, epoch: int) -> None:
        self._cur_epoch = epoch
        res = self.admission.poll()
        if res is not None:
            self._apply(res)
        if self.server is not None:
            self.server.set_params(trainer.state.params)

    def _apply(self, res) -> int:
        """Admit one drained batch: append to the source, grow the store
        and sampler, and install the measured losses as the rows' first
        Eq. (3.1) update (from the fresh 1/n' prior)."""
        adm = res.admitted
        n_adm = int(adm.sum())
        self.admit_log.append({
            "epoch": self._cur_epoch, "step": self.trainer.global_step,
            "scored": int(len(res.losses)), "admitted": n_adm,
            "mean_loss": float(res.losses.mean()) if len(res.losses)
            else 0.0})
        if n_adm == 0:
            return 0
        tr = self.trainer
        ids = self.source.append(res.tokens[adm], res.labels[adm])
        tr.grow(len(ids), self._cur_epoch)
        dev = tr.device
        tr.state.scores = tr.store.update(
            tr.state.scores, torch.as_tensor(ids, dtype=torch.int32,
                                             device=dev),
            torch.as_tensor(res.losses[adm], dtype=torch.float32,
                            device=dev),
            tr.es_cfg.beta1, tr.es_cfg.beta2, fused=tr.es_cfg.fused_scores)
        return n_adm


def _synthetic_stream(seq_len: int, vocab: int, seed: int, n: int):
    """(tokens, labels) candidate rows: even rows a repeated 3-token motif
    (what ES should admit), odd rows uniform noise."""
    r = np.random.default_rng(seed)
    tokens = np.zeros((n, seq_len), np.int32)
    for i in range(n):
        if i % 2 == 0:
            motif = r.integers(1, vocab, 3)
            tokens[i] = np.tile(motif, seq_len // 3 + 1)[:seq_len]
        else:
            tokens[i] = r.integers(1, vocab, seq_len)
    labels = np.concatenate([tokens[:, 1:], np.full((n, 1), -1, np.int32)],
                            axis=1)
    return tokens, labels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Online ES scoring service "
                                 "(PyTorch port)")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--n-samples", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=24)
    ap.add_argument("--meta-batch", type=int, default=8)
    ap.add_argument("--minibatch", type=int, default=None,
                    help="default: half the meta-batch")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=50.0)
    ap.add_argument("--submit-every", type=int, default=2,
                    help="submit a candidate batch every K trained steps")
    ap.add_argument("--submit-batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--bench-out", default=None,
                    help="write admission-latency stats as a bench_trend "
                         "rows JSON")
    return ap


def build(args) -> tuple:
    """The trainer over a StreamingSource, the service and the candidate
    rows the CLI's arguments describe."""
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    vocab = min(cfg.vocab_size, 64)
    tc = TrainerConfig(arch=args.arch, smoke=args.smoke, method="es",
                       epochs=args.epochs, meta_batch=args.meta_batch,
                       minibatch=args.minibatch or max(args.meta_batch // 2,
                                                       1),
                       n_samples=args.n_samples, seq_len=args.seq_len,
                       anneal_ratio=0.0, device=args.device)
    base = SyntheticSource(SyntheticLM(SyntheticConfig(
        n_samples=args.n_samples, seq_len=args.seq_len, vocab_size=vocab,
        seed=tc.seed)))
    trainer = Trainer(tc, source=StreamingSource(base))
    svc = ScoringService(trainer, tau=args.tau, max_batch=args.max_batch,
                         max_delay_s=args.max_delay_ms / 1e3)
    tok, lab = _synthetic_stream(args.seq_len, vocab, seed=1, n=256)
    return trainer, svc, tok, lab


def feed(svc: ScoringService, tok: np.ndarray, lab: np.ndarray,
         every: int, size: int) -> None:
    """Submit the next ``size`` candidate rows every ``every`` trained
    steps, from a hook after the service's own."""
    cursor = [0]

    def feeder(tr, epoch):
        if tr.global_step % max(every, 1) == 0:
            lo = cursor[0]
            hi = min(lo + size, len(tok))
            if lo < hi:
                svc.submit(tok[lo:hi], lab[lo:hi])
                cursor[0] = hi
    svc.trainer.step_hooks.append(feeder)


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    trainer, svc, tok, lab = build(args)
    feed(svc, tok, lab, args.submit_every, args.submit_batch)
    t0 = time.perf_counter()
    out = trainer.train()
    svc.flush()
    wall = time.perf_counter() - t0
    dec = svc.decode(tok[:2, :8], args.gen)
    stats = svc.admission.latency_stats()
    n0, n1 = args.n_samples, trainer.n_train
    report = {"device": str(trainer.device), "steps": out["steps"],
              "final_loss": out["final_loss"], "base_rows": n0,
              "rows_now": n1, "streamed": n1 - n0,
              "submitted": svc.admission.submitted,
              "admitted_total": svc.admission.admitted,
              "epoch_log": out["epoch_log"],
              "decode_shape": list(dec.shape), "wall_s": wall, **stats}
    print(json.dumps(report, indent=1))
    if args.bench_out:
        rows = [{"method": "admission", "k": args.max_batch, **stats,
                 "steps": out["steps"], "streamed": n1 - n0}]
        Path(args.bench_out).write_text(json.dumps({"rows": rows}, indent=1))
    return report


if __name__ == "__main__":
    main()
