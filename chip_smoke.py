#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --store-bench SRC   # store timings of another tree
    python3 chip_smoke.py --segsum-bench SRC  # segment-sum timings of one

Phases, run in order, each of which raises on failure (nothing is caught):

1. ``build`` the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together; ctypes);
2. ``device``: the card (``nvidia-smi`` name and power limit, torch's name);
3. ``check`` each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged shapes (the edges of the flash
   kernel's 128-query tiles and the xent kernels' 128 x 256 tiles and
   64-deep k slices; the two xent kernels also one by one; the other
   families' (M, V, d) and flash shapes, head dim 80 included); the f32 score
   update with duplicate, -1 and out-of-range ids, one id, 512 ids over
   64 rows and a batch above its 4,096-id chunk, plus the duplicate-id
   pin; the three int8 store kernels (grow/re-code, ring slots, apply)
   one by one, with a warm ring, slots >= R and growing and steady
   scales, and the whole int8 store update against the plain versions
   bitwise, over chains of updates with and without growth; both stores
   grown on the card (f32 and int8 at n = 65,536 and 2^24) bitwise to
   the same grow of a host copy, then one kernel update over old and new
   rows against the plain versions; the two
   segment-sum kernels (forward and gradient) on path A's batch and on
   random ids up to 32,771 tokens a row and 150 slots, unaligned pointers
   and rows shorter than a vector, each case run twice and compared
   bitwise (no atomics);
4. ``time`` each kernel, its plain version and one PyTorch library call
   with CUDA events, the kernels alone under torch.profiler (device ms;
   the library call's too), compute each kernel's bound from its inputs,
   an empty kernel's device time (the floor of any launch), and the two
   stores' update calls at n = 65,536 and 2^24 (device time, launches per
   call, host clock, temporary memory); the segment sum, its gradient and
   the autograd pair of the two at three shapes of 8,192 tokens (also the
   wrappers' host time per call);
5. ``model``: the full-width scoring forward (kernels) against the training
   forward (plain autograd) on a small input;
6. the eleven main paths on full-width qwen1.5-0.5b through the trainer
   the CLI builds (``Trainer.train``), every launch count set to 0 just
   before and read just after, each taking its batches through the
   prefetching data pipeline,
   each training with the config's memory knobs (selective remat, query
   chunks of 512, cross-entropy chunks of 1,024 where S exceeds them):
   ``train`` (serial ES, f32 store), ``train_packed`` (packed token-level
   ES, ``--pack``, 4 slots a row), ``train_quant`` (serial ES over the
   int8 store, ``--quant-scores``), ``train_pipelined`` (``--pipelined``:
   the prime's scoring leg, then four pipelined steps, scoring on a
   second stream), 4 steps each, ``train_drift`` (``--freq-schedule drift
   --score-every 8``), 8 steps, ``train_packed_m16`` (16 slots a row
   of 1,024 tokens), 2 steps, ``train_long`` (sequences of 2,048, 8 a
   meta-batch, 2 trained: every knob fires) and ``train_packed_mb32``
   (path A at meta-batch 32), 4 steps each; and set-level pruning over
   256 samples, 2 epochs, a prune decision before each: ``train_eswp``
   (``--method eswp --prune-cadence drift`` at S1's shape, 205 kept, 6
   steps an epoch), ``train_infobatch`` (baseline steps over 16 rows with
   InfoBatch's kept-set and grad scales) and ``train_packed_eswp`` (path
   A, documents pruned inside rows); the launches per scoring leg (serial
   paths; the pipelined path's prime counts one, the drift path's legs
   are the summary's scoring steps) or per step (packed and baseline
   paths), the scoring-step count and finite losses are asserted, and
   for the pruned paths the prune events the reference's rules give, the
   kept-set's size, each epoch's step count as the sampler gives it and
   InfoBatch's weighted mean against the unweighted one on one batch;
   then ``train_tokens`` (S1's samples written as a uint16 token file in
   a temporary directory, ``--source tokens --num-hosts 2 --host-id 1``:
   each step's ids are host 1's half of the global meta-batch);
   ``serve`` (``Server.generate`` on full-width qwen1.5-0.5b: batch 8,
   prompts of 512, 64 greedy tokens; one flash launch a layer in the
   prefill and nothing else; the prefill's logits against the plain
   prefill's on the card and 4 teacher-forced decode steps against the
   full forward, both within 5e-2; prefill ms, ms per decoded token,
   tokens/s, peak memory); ``service`` (the online service's CLI at full
   width: 256 samples of 512 in a StreamingSource, meta-batch 32,
   minibatch 8, 2 epochs, 8 candidates every 2 steps, tau 1, drains of
   8: each drain's launches (24 flash, one xent call, one score update
   when it admits), the grown store, sampler and source, epoch 1's steps
   over the admitted rows, a decode from the live weights; the admission
   latency); then the other families and ``--grad-compression`` (phase
   6c), each through the same entry points: ``train_mamba2``
   (mamba2-780m at its published widths and depth, S1's traffic: one xent
   call and one store update a step, no flash), ``train_zamba2``
   (zamba2-2.7b at its published widths and depth, meta-batch 16,
   minibatch 4: nine flash launches at head dim 80 a scoring leg),
   ``train_moe`` (arctic's smoke config: 8 experts top-2 and a dense
   residual) and ``train_gc`` (S1 with ``--grad-compression``), 4 steps
   each; each family path holds its first scoring leg's per-sample losses
   to the plain forward (``scoring=False``, no grad) on the same batch
   and weights within 5e-2 and reports its scoring and training legs
   (host clock and device time); ``train_gc`` reports the compression
   leg and the residuals' bytes and holds ``compress_decompress`` on the
   card to a CPU copy bitwise; ``serve_mamba2`` (full-width mamba2, no
   kernel launch at all) and ``serve_moe`` (grok-1 at its published
   widths cut to 2 layers, 16 tokens; the checks at a dropless capacity)
   as ``serve``;
7. ``legs``: where a step's time goes (serial-ES legs and a profiled step;
   the packed step's legs and the segment-sum kernels' launches and device
   time inside its forward + backward; the int8 store update against the
   f32 one and its profiled launches). Legs are timed as the trainer times
   a step: host clock around a call that ends in a device sync;
8. ``data``: the data layer at the synthetic 32 x 512 and the packed
   16 x 512 x 4 batch: host ms to build, to pin, and to pin and copy a
   batch; the trainer with prefetch on and off in turns (median step, the
   consumer's stall in next(), the untraced device busy share);
9. ``legs_pipelined``: one pipelined step against one serial step in the
   same call (whole-step ms; a trace read by CUDA stream: the scoring
   kernels must run on a stream the serial step does not use, and the
   device time both streams are busy), and the host syncs of one step of
   each under torch's sync debug mode, also with the drift cadence firing;
10. ``memory``: ``train``, ``train_packed``, ``train_packed_m16`` and
   ``train_long`` with the memory knobs off and on, in turns (peak device
   memory, the training leg's time and device time, the scoring leg, the
   median step) and ``train`` with remat "full";
11. ``prune``: the f32 and the int8 store at n = 2^20 and 2^24 rows,
   filled through their update kernels; the snapshot's time (device sync
   and copy to the host) held bitwise against the store's tensors copied
   plainly, and each set-level method's decision time on it, its kept-set
   held against ``prune_epoch`` on those arrays;
12. ``resume``: ``train``, ``train_pipelined`` (a held batch),
   ``train_quant`` (the int8 ring) and ``train_gc`` (the gradients'
   residuals) killed after 2 steps with
   ``--ckpt-dir`` and resumed to 4, against 4 steps straight, and
   ``train_eswp`` killed at step 8 (mid-epoch 1, after a prune) and
   resumed to 12: the tail's losses, every leaf of the final state, the
   kept-set's digest and ``prev_epoch_losses`` bitwise equal, with the
   checkpoint's snapshot, write and restore times and its bytes on disk;
   and ``train_grown`` (S1 over 64 samples in a StreamingSource, a step
   hook appending 32 rows and growing at step 1) killed at 2 and resumed
   to 4: the same, and the grown store, source and cursor restored.
   It runs in a child process (``--resume-phase``) under
   ``torch.use_deterministic_algorithms(True)`` and
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, with its checkpoints in a
   temporary directory that is removed.

It prints one JSON object per line; the line before the last is the
``kernels`` summary, and the last is the device line. It
exits non-zero without a result when no CUDA device is present or the port
is missing. It imports nothing of JAX and nothing of the JAX package
``repro``. ``--store-bench SRC`` runs only the store timings of phase 4,
through the store API every tree of the port has, on the port under SRC
(e.g. a parent commit unpacked with ``git archive``), for comparisons in
one call. ``--segsum-bench SRC`` does the same for the segment sum's
wrapper, its autograd backward and the pair of them at the three shapes,
and traces path A's forward + backward; a tree whose kernel refuses a
slot count reports ``"refused"``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

FULL = ["--arch", "qwen1.5-0.5b", "--full", "--method", "es", "--seq-len",
        "512", "--max-steps", "4", "--device", "cuda"]
TRAIN_ARGS = FULL + ["--meta-batch", "32", "--minibatch", "8",
                     "--n-samples", "1024"]
PACK_ARGS = FULL + ["--pack", "--max-segments", "4", "--meta-batch", "16",
                    "--minibatch", "16", "--n-samples", "1024"]
# 16 documents a row of 1,024 tokens: 8,192 tokens a step, as on path A
PACK16_ARGS = FULL + ["--pack", "--max-segments", "16", "--seq-len", "1024",
                      "--meta-batch", "8", "--minibatch", "32",
                      "--n-samples", "1024", "--max-steps", "2"]
QUANT_ARGS = FULL + ["--quant-scores", "--quant-block", "1024",
                     "--meta-batch", "32", "--minibatch", "8",
                     "--n-samples", "65536"]
PIPELINED_ARGS = TRAIN_ARGS + ["--pipelined"]
DRIFT_ARGS = TRAIN_ARGS + ["--freq-schedule", "drift", "--score-every", "8",
                           "--max-steps", "8"]
# 2,048-token context, the train path's tokens a step (16,384 scored, 4,096
# trained): the three memory knobs all fire (4 query chunks of 512, 2
# cross-entropy chunks of 1,024, selective remat)
LONG_ARGS = FULL + ["--seq-len", "2048", "--meta-batch", "8", "--minibatch",
                    "2", "--n-samples", "1024"]
# path A at twice the meta-batch: 32 rows of 512, 128 document slots
# (fits the card with the memory knobs on)
PACK32_ARGS = PACK_ARGS + ["--meta-batch", "32"]
# set-level pruning, 2 epochs of 256 samples (a prune decision before
# each; the first is "first-prune"). The step caps are above the runs'
# lengths, which the sampler sets: ESWP at S1's shape keeps round(0.8 *
# 256) = 205 samples, 6 steps an epoch; InfoBatch takes baseline steps
# over 16 rows (A's 8,192 tokens), its kept-set and grad scales from the
# scores; packed ESWP prunes documents inside path A's rows
ESWP_ARGS = FULL + ["--method", "eswp", "--prune-cadence", "drift",
                    "--meta-batch", "32", "--minibatch", "8",
                    "--n-samples", "256", "--epochs", "2",
                    "--max-steps", "64"]
INFOBATCH_ARGS = FULL + ["--method", "infobatch", "--meta-batch", "16",
                         "--n-samples", "256", "--epochs", "2",
                         "--max-steps", "64"]
PACKED_ESWP_ARGS = PACK_ARGS + ["--method", "eswp", "--n-samples", "256",
                                "--epochs", "2", "--max-steps", "64"]
# launches per unit of each path on qwen1.5-0.5b (24 layers): a unit is a
# scoring leg on the serial-ES paths (one xent wrapper call: the partials
# and the combine kernel; one flash per layer; one store update) and a
# trained step on the packed paths; a kernel left out of a path's dict
# must not launch there
SCORING_LEG = {"fused_xent": 1, "gqa_flash_attention": 24,
               "fused_score_update": 1}
PER_UNIT = {
    "train": SCORING_LEG,
    # packed: one differentiated forward (plain attention and xent), one
    # segment sum and its gradient, one f32 score update over the
    # meta-batch's document slots
    "train_packed": {"segment_sum": 1, "segment_sum_grad": 1,
                     "fused_score_update": 1},
    "train_packed_m16": {"segment_sum": 1, "segment_sum_grad": 1,
                         "fused_score_update": 1},
    "train_packed_mb32": {"segment_sum": 1, "segment_sum_grad": 1,
                          "fused_score_update": 1},
    # serial ES over the int8 store: the store update is the grow, the
    # ring-slot and the apply kernel
    "train_quant": {"fused_xent": 1, "gqa_flash_attention": 24,
                    "quant_grow_scales": 1, "quant_ring_slots": 1,
                    "fused_quant_score_update": 1},
    "train_pipelined": SCORING_LEG,
    "train_drift": SCORING_LEG,
    "train_long": SCORING_LEG,
    "train_eswp": SCORING_LEG,
    # baseline steps: no scoring leg; the store updates from the training
    # forward's per-sample losses
    "train_infobatch": {"fused_score_update": 1},
    "train_packed_eswp": {"segment_sum": 1, "segment_sum_grad": 1,
                          "fused_score_update": 1},
    "train_tokens": SCORING_LEG,
    # the other families (phase 6c): a scoring leg is one xent call, one
    # flash launch per attention layer (mamba2: none; zamba2: the shared
    # block at each of its 9 sites; arctic smoke: 2 layers) and one store
    # update; --grad-compression launches nothing of its own
    "train_mamba2": {"fused_xent": 1, "fused_score_update": 1},
    "train_zamba2": {"fused_xent": 1, "gqa_flash_attention": 9,
                     "fused_score_update": 1},
    "train_moe": {"fused_xent": 1, "gqa_flash_attention": 2,
                  "fused_score_update": 1},
    "train_gc": SCORING_LEG,
}


def path_units(name: str, n_steps: int, out: dict) -> int:
    """Units a path runs: its trained steps, but for two paths. The
    pipelined path's prime scores the first batch before the first step
    (4 steps stop mid-epoch: no flush), so it runs one scoring leg more
    than steps; the drift path scores where its servo fires, which the
    summary counts."""
    if name == "train_pipelined":
        return n_steps + 1
    if name == "train_drift":
        return int(out["scoring_steps_total"])
    return n_steps


XENT_TOL = 1e-3     # float32 sums in another order, __expf
# bf16 output (one ulp is 2^-6 at |o| in [2, 4)); probabilities enter PV
# as bf16: |err| <= FLASH_TOL + FLASH_RTOL * |plain|
FLASH_TOL = 2e-2
FLASH_RTOL = 1e-2
SCORE_TOL = 0.0     # same float32 roundings, no FMA contraction
# segment sum: counts exact; sums in another order than the plain version:
# |err| <= SEGSUM_RTOL * max(1, |plain|)
SEGSUM_RTOL = 1e-6
# int8 update: codes, seen and ring ids/stamps exact; the residuals use
# the plain version's roundings (no FMA contraction), so 0 is expected
# and 1e-7 (the reference kernel test's) is the tolerance
QUANT_RESID_TOL = 1e-7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median host-clock time of one call that ends in a device sync, the
    way the trainer times a step (the call's host path counts)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


TRACE_PAD_S = 0.02


def _device_rows(fn, reps: int) -> list:
    """torch.profiler's device rows (kernels and copies) over ``reps``
    calls of ``fn``, after one call in the tracer's warm-up step. The
    recorded window is padded with TRACE_PAD_S of idle host time on each
    side: the tracer drops device events that fall outside its host-clock
    window, and unpadded windows of a few microsecond launches lost some
    of them on the H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    # device rows: kernels and copies (the step annotation is not work)
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not e.key.startswith("ProfilerStep")]


def device_trace(fn, reps: int = 20) -> dict:
    """Device launches per call of ``fn`` and their device time per call."""
    rows = _device_rows(fn, reps)
    return {"launches_per_call": sum(e.count for e in rows) / reps,
            "device_ms": sum(e.self_device_time_total
                             for e in rows) / 1e3 / reps}


def kernel_device_ms(fn, *kernels: str, reps: int = 20) -> float:
    """Mean device time per call of ``fn`` of the CUDA kernels named
    ``kernels`` (each launched once per call) over ``reps`` calls, from
    torch.profiler. For kernels that take microseconds the CUDA events of
    ``time_ms`` read the wrapper's host path (checks, allocation, the
    ctypes call) while the device idles; this reads the kernels alone.
    A trace that misses launches (the profiler has dropped some) is taken
    again, at most four more times."""
    for _ in range(5):
        all_rows = _device_rows(fn, reps)
        counts, total = [], 0.0
        for kernel in kernels:
            rows = [e for e in all_rows if kernel in e.key]
            counts.append(sum(e.count for e in rows))
            total += sum(e.self_device_time_total for e in rows) / 1e3 / reps
        if all(c == reps for c in counts):
            return total
    raise AssertionError(f"profiler saw {counts} launches of {kernels}, "
                         f"expected {reps} each")


# ---------------------------------------------------------------------------
# phases 1-2: build, device
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.library()
    resources = [ln.strip() for ln in _build.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or ln.startswith("==")
                 or "entry function" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "ptxas": resources})


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device() -> None:
    emit({"phase": "device", "nvidia_smi": smi_line(),
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def xent_inputs(M: int, V: int, d: int, seed: int = 0):
    g = _gen(seed)
    h = torch.randn(M, d, device="cuda", generator=g).to(torch.bfloat16)
    w = (0.02 * torch.randn(V, d, device="cuda", generator=g)
         ).to(torch.bfloat16)
    labels = torch.randint(0, V, (M,), device="cuda", generator=g,
                           dtype=torch.int32)
    return h, w, labels


def flash_inputs(B: int, S: int, H: int, K: int, hd: int, seed: int = 0):
    g = _gen(seed)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g)
    k = torch.randn(B, S, K, hd, device="cuda", generator=g)
    v = torch.randn(B, S, K, hd, device="cuda", generator=g)
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


def score_inputs(n: int, ids, seed: int = 0):
    g = _gen(seed)
    s = torch.rand(n, device="cuda", generator=g)
    w = torch.rand(n, device="cuda", generator=g)
    seen = torch.randint(0, 5, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    ids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
    losses = 3 * torch.rand(ids.shape[0], device="cuda", generator=g)
    return s, w, seen, ids, losses


def _perm(n: int, k: int) -> list:
    g = torch.Generator().manual_seed(0)
    return torch.randperm(n, generator=g)[:k].tolist()


def _dup_ids(n: int, B: int, distinct: int, seed: int = 0) -> list:
    """B ids drawn (with repeats) from ``distinct`` random rows of n."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(n, generator=g)[:distinct]
    return rows[torch.randint(0, distinct, (B,), generator=g)].tolist()


def check_xent(M: int, V: int, d: int) -> float:
    from repro_torch.kernels.xent.ops import fused_xent
    from repro_torch.kernels.xent.ref import xent_ref
    h, w, labels = xent_inputs(M, V, d)
    got = fused_xent(h, w, labels)
    want = xent_ref(h, w, labels)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= XENT_TOL:
        raise AssertionError(f"xent M={M} V={V} d={d}: max |err| {err} > "
                             f"{XENT_TOL}")
    return err


def check_xent_parts(M: int, V: int, d: int) -> float:
    """The card's two xent kernels one by one at the wrapper's split: the
    partials kernel against ``xent_partials_ref`` (max and label logit
    absolute, sumexp relative to the plain one), the combine kernel
    against ``xent_combine_ref`` on the plain partials."""
    from repro_torch.kernels.xent.ops import (_num_sms, vocab_split,
                                              xent_combine, xent_partials)
    from repro_torch.kernels.xent.ref import (xent_combine_ref,
                                              xent_partials_ref)
    h, w, labels = xent_inputs(M, V, d, seed=1)
    n_split, span = vocab_split(M, V, _num_sms(0))
    got = xent_partials(h, w, labels, span)
    want = xent_partials_ref(h, w, labels, span)
    nll = xent_combine(want)
    want_nll = xent_combine_ref(want)
    torch.cuda.synchronize()
    errs = [(got[..., 0] - want[..., 0]).abs().max().item(),
            (got[..., 1] / want[..., 1] - 1).abs().max().item(),
            (got[..., 2] - want[..., 2]).abs().max().item(),
            (nll - want_nll).abs().max().item()]
    if got.shape != (M, n_split, 3) or not max(errs) <= XENT_TOL:
        raise AssertionError(f"xent parts M={M} V={V} d={d} split "
                             f"{n_split}x{span}: shape {tuple(got.shape)}, "
                             f"|err| max/sumexp rel/label/combine {errs} "
                             f"> {XENT_TOL}")
    return max(errs)


def check_flash(B: int, S: int, H: int, K: int, hd: int,
                causal: bool) -> float:
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    q, k, v = flash_inputs(B, S, H, K, hd)
    got = gqa_flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not bool((diff <= FLASH_TOL + FLASH_RTOL * want.float().abs()).all()):
        raise AssertionError(f"flash B={B} S={S} H={H} K={K} hd={hd} "
                             f"causal={causal}: max |err| {err} beyond "
                             f"{FLASH_TOL} + {FLASH_RTOL} * |plain|")
    return err


def check_score(n: int, ids) -> float:
    from repro_torch.kernels.score_update.ops import fused_score_update
    from repro_torch.kernels.score_update.ref import score_update_ref
    got = score_inputs(n, ids)
    want = [x.clone() for x in got]
    fused_score_update(*got, beta1=0.2, beta2=0.9)
    score_update_ref(*want, beta1=0.2, beta2=0.9)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[:3], want[:3]))
    if not err <= SCORE_TOL:
        raise AssertionError(f"score_update n={n} B={len(ids)}: max |err| "
                             f"{err} > {SCORE_TOL}")
    return err


def segsum_inputs(B: int, S: int, M: int, seed: int = 0, offset: int = 0):
    """Random per-token NLL, segment ids in [0, M+1] in any order (M+1 is
    in no slot) and a live mask; ``offset`` > 0 starts each (B, S) tensor
    that many elements into its allocation (pointers off 16 bytes)."""
    g = _gen(seed)
    n = B * S + offset
    nll = (5 * torch.rand(n, device="cuda", generator=g))[offset:]
    seg = torch.randint(0, M + 2, (n,), device="cuda", generator=g,
                        dtype=torch.int32)[offset:]
    mask = (torch.rand(n, device="cuda", generator=g) < 0.9)[offset:]
    return nll.view(B, S), seg.view(B, S), mask.view(B, S)


def packed_segsum_inputs(B: int = 16, S: int = 512, M: int = 4,
                         seed: int = 0):
    """A packed layout as the trainer builds it: the first B rows of the
    packed source of 1,024 synthetic documents at S and M (path A: S =
    512, M = 4), random per-token NLL."""
    import numpy as np
    from repro_torch.data.packed import PackedSource
    src = PackedSource.synthetic(1024, S, max_segments=M, vocab=64, seed=0)
    b = src.batch(np.arange(B))
    seg = torch.from_numpy(b["segment_ids"]).cuda()
    mask = torch.from_numpy(b["labels"] != -1).cuda()
    nll = 5 * torch.rand(B, S, device="cuda", generator=_gen(seed))
    return nll, seg, mask


def check_segsum(nll, seg, mask, M: int):
    """Both segment-sum kernels against their plain versions, each run
    twice with the two outputs compared bitwise (no atomics): counts and
    the gradient exact (also for an expanded gradient, stride 0 along the
    slots, as autograd hands down from a sum), sums within SEGSUM_RTOL;
    then the autograd Function against autograd through the plain
    version. Returns the max |err| of the sums and of the gradient."""
    from repro_torch.kernels.segsum.ops import (segment_sum,
                                                segment_sum_autograd,
                                                segment_sum_grad)
    from repro_torch.kernels.segsum.ref import (segment_sum_grad_ref,
                                                segment_sum_ref)
    what = f"segsum {tuple(nll.shape)} M={M}"
    runs = [segment_sum(nll, seg, mask, max_segments=M) for _ in range(2)]
    want_s, want_c = segment_sum_ref(nll, seg, mask, max_segments=M)
    up = torch.rand(nll.shape[0], M, device="cuda", generator=_gen(9)) - 0.5
    ups = (up, up[:, :1].expand(-1, M))
    grads = [segment_sum_grad(u, seg, mask, max_segments=M)
             for u in (up, up, ups[1])]
    want_g = [segment_sum_grad_ref(u, seg, mask, max_segments=M)
              for u in ups]
    torch.cuda.synchronize()
    for a, b in zip(runs[0] + (grads[0],), runs[1] + (grads[1],)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two runs differ")
    got_s, got_c = runs[0]
    if not torch.equal(got_c, want_c):
        raise AssertionError(f"{what}: counts differ")
    diff = (got_s - want_s).abs()
    if not bool((diff <= SEGSUM_RTOL * want_s.abs().clamp(min=1.0)).all()):
        raise AssertionError(f"{what}: max |err| {diff.max().item()} beyond "
                             f"{SEGSUM_RTOL} relative")
    if not (torch.equal(grads[0], want_g[0])
            and torch.equal(grads[2], want_g[1])):
        raise AssertionError(f"{what}: gradient differs")
    # the autograd.Function (forward and gradient kernels) against
    # autograd through the plain version (the same gather: exact)
    back = []
    for fn in (segment_sum_autograd, segment_sum_ref):
        x = nll.clone().requires_grad_(True)
        (fn(x, seg, mask, max_segments=M)[0] * up).sum().backward()
        back.append(x.grad)
    if not torch.equal(back[0], back[1]):
        raise AssertionError(f"{what}: autograd backward differs")
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(grads[::2], want_g))
    return diff.max().item(), grad_err


QUANT_NAMES = ("s_q", "w_q", "seen_q", "err_rows", "err_seq", "err_s",
               "err_w")


def quant_inputs(n: int, B: int, R: int, block: int, seed: int = 0):
    """Arguments of the int8 kernel after the store's own prologue, on a
    store warmed by one update of the same rows (so the ring holds their
    residuals): duplicate ids, -1 and out-of-range ids, and two slots
    forced to R (residual dropped)."""
    from repro_torch.core.scores import make_store
    from repro_torch.kernels.score_update.ref import (quant_grow_scales_ref,
                                                      quant_ring_slots_ref)
    st = make_store(None, quantize=True, block=block, residual_rows=R)
    qs = st.init_leaf(n, "cuda")
    g = _gen(seed)
    ids = torch.randperm(n, device="cuda", generator=g)[:B].to(torch.int32)
    st.update(qs, ids, 3 * torch.rand(B, device="cuda", generator=g), 0.2,
              0.9, fused=False)
    ids = ids.clone()
    ids[3] = ids[1]
    ids[7] = ids[1]
    ids[10] = ids[4]
    ids[5] = -1
    ids[12] = -1
    ids[15] = n + 3
    losses = 3 * torch.rand(B, device="cuda", generator=g)
    mask = (ids >= 0) & (ids < n)
    quant_grow_scales_ref(qs.s_q, qs.w_q, qs.s_scale, qs.w_scale,
                          qs.err_rows, qs.err_seq, qs.err_s, ids, ids,
                          losses, beta1=0.2, beta2=0.9, block=block)
    slots, seqs = quant_ring_slots_ref(qs.err_seq, mask)
    slots[2] = R
    slots[9] = R + 5
    mg = torch.where(mask, ids, torch.full_like(ids, -1))
    lids = torch.where(mask, ids, torch.full_like(ids, -1))
    return [qs.s_q, qs.w_q, qs.seen_q, qs.s_scale, qs.w_scale, qs.err_rows,
            qs.err_seq, qs.err_s, qs.err_w, lids.contiguous(),
            mg.contiguous(), losses, slots, seqs]


def check_quant(n: int, B: int, R: int, block: int) -> float:
    from repro_torch.kernels.score_update.ops import fused_quant_score_update
    from repro_torch.kernels.score_update.ref import quant_score_update_ref
    args = quant_inputs(n, B, R, block)
    got = fused_quant_score_update(*(x.clone() for x in args), beta1=0.2,
                                   beta2=0.9, block=block)
    want = quant_score_update_ref(*(x.clone() for x in args), beta1=0.2,
                                  beta2=0.9, block=block)
    torch.cuda.synchronize()
    hits = int(torch.isin(args[10][args[10] >= 0], args[5]).sum())
    if hits == 0:
        raise AssertionError("int8 check: the warm ring holds no batch row")
    err = 0.0
    for name, a, b in zip(QUANT_NAMES, got, want):
        if name in ("err_s", "err_w"):
            e = (a - b).abs().max().item()
            err = max(err, e)
            if not e <= QUANT_RESID_TOL:
                raise AssertionError(f"int8 n={n} R={R}: {name} max |err| "
                                     f"{e} > {QUANT_RESID_TOL}")
        elif not torch.equal(a, b):
            raise AssertionError(f"int8 n={n} R={R}: {name} differs")
    return err


QFIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
           "err_seq", "err_s", "err_w")


def _q_clone(qs):
    from repro_torch.core.scores import QuantizedScores
    return QuantizedScores(*(getattr(qs, f).clone() for f in QFIELDS))


def _q_compare(what: str, got, want) -> float:
    """Integer leaves and scales bitwise, residuals within
    QUANT_RESID_TOL; returns the residuals' max |err|."""
    err = 0.0
    for f in QFIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f in ("err_s", "err_w"):
            e = (a - b).abs().max().item()
            err = max(err, e)
            if not e <= QUANT_RESID_TOL:
                raise AssertionError(f"{what}: {f} max |err| {e} > "
                                     f"{QUANT_RESID_TOL}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: {f} differs")
    return err


def plain_store_update(qs, ids, losses, block: int) -> None:
    """The int8 store update from the three plain versions, in place: the
    whole update the kernels are held to."""
    from repro_torch.kernels.score_update.ref import (
        quant_grow_scales_ref, quant_ring_slots_ref, quant_score_update_ref)
    n = qs.s_q.shape[0]
    quant_grow_scales_ref(qs.s_q, qs.w_q, qs.s_scale, qs.w_scale, qs.err_rows,
                          qs.err_seq, qs.err_s, ids, ids, losses, beta1=0.2,
                          beta2=0.9, block=block)
    slots, seqs = quant_ring_slots_ref(qs.err_seq, (ids >= 0) & (ids < n))
    quant_score_update_ref(*(getattr(qs, f) for f in QFIELDS), ids, ids,
                           losses, slots, seqs, beta1=0.2, beta2=0.9,
                           block=block)


def _batch_ids(rows: torch.Tensor, B: int, n: int, g,
               repeats: bool) -> torch.Tensor:
    """B ids drawn from ``rows`` (with repeats and a forced duplicate, or
    distinct), two of them -1 and one out of range when B allows."""
    if repeats:
        ids = rows[torch.randint(0, rows.shape[0], (B,), device="cuda",
                                 generator=g)].to(torch.int32)
        ids[B // 3] = ids[0]
    else:
        ids = rows[torch.randperm(rows.shape[0], device="cuda",
                                  generator=g)[:B]].to(torch.int32)
    if B >= 8:
        ids[B // 2] = -1
        ids[B - 2] = n + 3
        ids[B - 1] = -1
    return ids.contiguous()


def check_store(n: int, B: int, R: int, block: int, growth) -> float:
    """The whole int8 store update on the card (grow, slot and apply
    kernels through ``QuantizedStore.update``) against the plain versions
    on a copy of the same store, bitwise, over ``len(growth)`` chained
    updates. A hot set of 2B rows takes every update; the first update
    covers it. A step marked True draws distinct ids and losses above
    every earlier one (some scale grows), a step marked False draws
    duplicates and tiny losses (none grows), and the marks are asserted
    on the plain copy. (Duplicates in a growth step could clip: the grow
    sizes the scales from pre-batch values, as the reference does, and
    the next step would grow again.)"""
    from repro_torch.core.scores import make_store
    st = make_store(None, quantize=True, block=block, residual_rows=R)
    a = st.init_leaf(n, "cuda")
    g = _gen(n + B + R)
    hot = torch.randperm(n, device="cuda", generator=g)[:2 * B]
    err, top = 0.0, 1.0
    for step, grows in enumerate(growth):
        ids = hot.to(torch.int32) if step == 0 else _batch_ids(
            hot, B, n, g, repeats=not grows)
        if grows:
            top *= 2.0
            losses = top * (1.0 + torch.rand(ids.shape[0], device="cuda",
                                              generator=g))
        else:
            losses = 0.01 * torch.rand(ids.shape[0], device="cuda",
                                       generator=g)
        b = _q_clone(a)
        scales = (b.s_scale.clone(), b.w_scale.clone())
        st.update(a, ids, losses, 0.2, 0.9)
        plain_store_update(b, ids, losses, block)
        torch.cuda.synchronize()
        err = max(err, _q_compare(f"int8 store n={n} B={B} R={R} "
                                  f"block={block} step {step}", a, b))
        grew = not (torch.equal(scales[0], b.s_scale)
                    and torch.equal(scales[1], b.w_scale))
        if grew != grows:
            raise AssertionError(f"int8 store step {step}: scales grew "
                                 f"{grew}, the step was built for {grows}")
        a = b       # the next step starts from one state on both sides
    if (a.err_seq > 0).sum().item() < min(R, 2 * B):
        raise AssertionError("int8 store check: the ring never filled")
    return err


def check_grow(n: int, B: int, R: int, block: int, scale: float) -> float:
    """The grow kernel alone against its plain version on a warm store
    (ring filled, duplicates, masked ids); ``scale`` sizes the losses
    against the warm-up's (1 keeps the scales, > 1 grows them)."""
    from repro_torch.kernels.score_update.ops import quant_grow_scales
    from repro_torch.kernels.score_update.ref import quant_grow_scales_ref
    args = quant_inputs(n, B, R, block, seed=1)
    leaves = args[:9]
    ids = args[9]
    losses = scale * args[11]
    got = [x.clone() for x in (*leaves[:2], *leaves[3:8])]
    want = [x.clone() for x in got]
    quant_grow_scales(*got, ids, args[10], losses, beta1=0.2, beta2=0.9,
                      block=block)
    quant_grow_scales_ref(*want, ids, args[10], losses, beta1=0.2,
                          beta2=0.9, block=block)
    torch.cuda.synchronize()
    for name, x, y in zip(("s_q", "w_q", "s_scale", "w_scale"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"grow n={n} B={B} x{scale}: {name} "
                                 f"differs")
    return 0.0


def check_grow_store(kind: str, n: int, n_new: int, B: int = 32) -> float:
    """A warm store of ``n`` rows grown by ``n_new`` on the card (f32, or
    int8 with blocks of 1,024 and a ring of 1,024), held bitwise to the
    same grow of a host copy and to its own old rows; then one update
    over old and new rows through the kernels (the f32 kernel, or the int8
    store's three) against the plain versions on a copy on the card."""
    from repro_torch.core.scores import make_store
    from repro_torch.kernels.score_update.ref import score_update_ref
    int8 = kind == "int8"
    st = make_store(None, quantize=int8, block=1024, residual_rows=1024)
    fields = QFIELDS if int8 else ("s", "w", "seen")
    g = _gen(n + n_new)
    leaf = st.init_leaf(n, "cuda")
    warm = torch.randperm(n, device="cuda", generator=g)[:B]
    st.update(leaf, warm.to(torch.int32),
              2.0 * torch.rand(B, device="cuda", generator=g), 0.2, 0.9)
    before = {f: getattr(leaf, f).clone() for f in fields}
    host = type(leaf)(**{f: getattr(leaf, f).cpu() for f in fields})
    _, grown = st.grow(leaf, n_new)
    _, plain = st.grow(host, n_new)
    torch.cuda.synchronize()
    what = f"{kind} grow n={n} +{n_new}"
    for f in fields:
        got, old = getattr(grown, f), before[f]
        if not torch.equal(got.cpu(), getattr(plain, f)):
            raise AssertionError(f"{what}: {f} differs from the host grow")
        if not torch.equal(got[:old.shape[0]], old):
            raise AssertionError(f"{what}: old {f} changed")
    ids = torch.cat([torch.randperm(n, device="cuda", generator=g)[:B - 8],
                     n + torch.randperm(n_new, device="cuda",
                                        generator=g)[:8]]).to(torch.int32)
    losses = 3.0 * torch.rand(B, device="cuda", generator=g)
    if int8:
        want = _q_clone(grown)
        st.update(grown, ids, losses, 0.2, 0.9)
        plain_store_update(want, ids, losses, 1024)
        torch.cuda.synchronize()
        return _q_compare(f"{what}, then an update", grown, want)
    want = [x.clone() for x in (grown.s, grown.w, grown.seen)]
    st.update(grown, ids, losses, 0.2, 0.9)
    score_update_ref(*want, ids, losses, beta1=0.2, beta2=0.9)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in
               zip((grown.s, grown.w, grown.seen), want)):
        raise AssertionError(f"{what}: the update after it differs")
    return 0.0


def check_slots(R: int, B: int, warm: int, n: int = 4096) -> float:
    """The ring-slot kernel against its plain version: ``warm`` distinct
    stamps (the rest 0) in random slots, a third of the batch masked."""
    from repro_torch.kernels.score_update.ops import quant_ring_slots
    from repro_torch.kernels.score_update.ref import quant_ring_slots_ref
    g = _gen(R + B + warm)
    seq = torch.zeros(R, dtype=torch.int32, device="cuda")
    at = torch.randperm(R, device="cuda", generator=g)[:warm]
    seq[at] = (1 + torch.randperm(3 * warm, device="cuda", generator=g)
               [:warm]).to(torch.int32)
    ids = torch.randint(0, n, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    ids[torch.rand(B, device="cuda", generator=g) < 0.33] = -1
    got = quant_ring_slots(seq, ids, n)
    want = quant_ring_slots_ref(seq, (ids >= 0) & (ids < n))
    torch.cuda.synchronize()
    for name, x, y in zip(("slots", "seqs"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"ring slots R={R} B={B} warm={warm}: "
                                 f"{name} differ")
    return 0.0


def phase_check() -> dict:
    errs = {
        # the 128-row x 256-column tiles' ragged edges: M < 128, V < 256,
        # d not a multiple of the 64-deep k slice, one live column in the
        # last vocab tile (V = 257; the main shape leaves 128)
        "fused_xent": max(check_xent(16384, 151936, 1024),
                          check_xent(300, 777, 64),
                          check_xent(200, 1000, 1024),
                          check_xent(100, 1000, 1024),
                          check_xent(300, 130, 64),
                          check_xent(200, 1000, 1000),
                          check_xent(300, 257, 128),
                          check_xent_parts(1024, 151936, 1024),
                          check_xent_parts(100, 257, 1000),
                          # the other families' scoring forwards (mamba2,
                          # zamba2, the arctic smoke path) and grok-1's
                          # (d, V), which no training path reaches
                          check_xent(16384, 50304, 1536),
                          check_xent(8192, 32000, 2560),
                          check_xent(16384, 128, 64),
                          check_xent(2048, 131072, 6144)),
        # 128-query tiles: S = 1000 causal GQA, one kv tile, one query;
        # every head dim
        "gqa_flash_attention": max(
            check_flash(32, 512, 16, 16, 64, True),
            check_flash(2, 200, 4, 4, 64, True),
            check_flash(2, 200, 4, 4, 64, False),
            check_flash(2, 256, 32, 8, 128, True),
            check_flash(1, 128, 4, 2, 16, True),
            check_flash(2, 1000, 16, 2, 64, True),
            check_flash(2, 64, 4, 4, 64, True),
            check_flash(3, 1, 4, 2, 64, True),
            check_flash(3, 1, 4, 2, 64, False),
            check_flash(2, 512, 8, 8, 128, True),
            check_flash(2, 300, 8, 4, 32, False),
            # head dim 80 (zamba2's shared block: five 16-wide panels) at
            # the path's shape and at ragged tiles; the MoE configs' GQA
            # 48:8 (grok-1) and 56:8 (arctic) at head dim 128
            check_flash(16, 512, 32, 32, 80, True),
            check_flash(2, 300, 4, 4, 80, False),
            check_flash(2, 1000, 8, 2, 80, True),
            check_flash(2, 512, 48, 8, 128, True),
            check_flash(2, 512, 56, 8, 128, True)),
        # the path's shape, duplicates with -1 and out-of-range ids, one
        # id, 512 ids over 64 rows, and a batch above the 4,096-id chunk
        # with duplicates across the boundary
        "fused_score_update": max(
            check_score(1024, _perm(1024, 32)),
            check_score(64, [3, 3, -1, 70, 5, 3, 63, -7]),
            check_score(1 << 20, [12345]),
            check_score(1 << 24, _dup_ids(1 << 24, 512, 64)),
            check_score(1 << 16, _dup_ids(1 << 16, 5000, 300, seed=1))),
        "fused_quant_score_update": max(check_quant(65536, 32, 1024, 1024),
                                        check_quant(1000, 32, 16, 64)),
        "quant_grow_scales": max(check_grow(65536, 32, 1024, 1024, 1.0),
                                 check_grow(65536, 32, 1024, 1024, 50.0),
                                 check_grow(1000, 100, 64, 16, 50.0)),
        "quant_ring_slots": max(check_slots(1024, 32, 1024),
                                check_slots(1024, 32, 0),
                                check_slots(64, 100, 40),
                                check_slots(16, 32, 16),
                                check_slots(8192, 2000, 5000)),
    }
    # both segment-sum kernels: the packed batches of path A (16 x 512, 4
    # slots) and of train_packed_m16 (8 x 1,024, 16 slots), random ids in
    # any order (1 to 64 slots, rows up to 8,192 tokens), three 64-slot
    # tiles with ragged rows, a ragged row of 32,771 tokens, pointers off
    # 16-byte alignment, rows shorter than a vector
    seg_errs = [check_segsum(*packed_segsum_inputs(), 4),
                check_segsum(*packed_segsum_inputs(8, 1024, 16), 16)] + [
        check_segsum(*segsum_inputs(B, S, M, offset=off), M)
        for B, S, M, off in ((7, 300, 5, 0), (16, 512, 8, 0),
                             (4, 2048, 16, 0), (1, 8192, 64, 0),
                             (3, 130, 1, 0), (2, 6003, 150, 0),
                             (1, 32771, 20, 0), (5, 203, 7, 1),
                             (9, 3, 2, 0))]
    errs["segment_sum"] = max(e[0] for e in seg_errs)
    errs["segment_sum_grad"] = max(e[1] for e in seg_errs)
    # the whole int8 store update (the three kernels) against the plain
    # versions: the path's shape, B > R with duplicates and masked ids,
    # and a chain of 8 updates with and without growth
    # both stores grown on the card (a partial tail block of new rows on
    # the int8 store at 2^24), then one kernel update over old and new rows
    errs["grow_then_update"] = max(
        check_grow_store("f32", 65536, 100),
        check_grow_store("f32", 1 << 24, 4096),
        check_grow_store("int8", 65536, 1500),
        check_grow_store("int8", 1 << 24, 1000))
    errs["int8_store_update"] = max(
        check_store(65536, 32, 1024, 1024, (True, False)),
        check_store(1000, 100, 64, 16, (True, False)),
        check_store(4096, 48, 256, 64,
                    (True, False, False, True, False, True, False, False)),
        check_store(1 << 16, 1500, 1024, 256, (True, False)))
    # the duplicate-id pin: sequential Eq. (3.1) ends at s = 2.75
    from repro_torch.kernels.score_update.ops import fused_score_update
    one = torch.ones(1, device="cuda")
    s, _, seen = fused_score_update(
        one.clone(), one.clone(), torch.zeros(1, dtype=torch.int32,
                                              device="cuda"),
        torch.zeros(2, dtype=torch.int32, device="cuda"),
        torch.tensor([2.0, 4.0], device="cuda"), beta1=0.5, beta2=0.5)
    torch.cuda.synchronize()
    if s.item() != 2.75 or seen.item() != 2:
        raise AssertionError(f"duplicate-id pin: s={s.item()}, "
                             f"seen={seen.item()}")
    emit({"phase": "check", "max_abs_err": errs})
    return errs


# ---------------------------------------------------------------------------
# phase 4: timing at the slice's shapes
# ---------------------------------------------------------------------------

def phase_time() -> dict:
    from repro_torch.kernels.xent.ops import fused_xent
    from repro_torch.kernels.xent.ref import xent_ref
    out = {}

    M, V, d = 32 * 512, 151936, 1024
    h, w, labels = xent_inputs(M, V, d)

    def xent_library():
        logits = h @ w.t()
        return (torch.logsumexp(logits.float(), -1)
                - logits.gather(1, labels.long()[:, None])[:, 0].float())

    flops, nbytes = 2.0 * M * V * d, 2 * M * d + 2 * V * d + 4 * M + 4 * M
    bms, by = bound(flops, nbytes)
    out["fused_xent"] = {
        "ms": time_ms(lambda: fused_xent(h, w, labels), 5),
        # both kernels of one call: partials, then the fold over splits
        "device_ms": kernel_device_ms(
            lambda: fused_xent(h, w, labels), "xent_partials_kernel",
            "xent_combine_kernel", reps=5),
        "plain_ms": time_ms(lambda: xent_ref(h, w, labels), 3),
        "library_ms": time_ms(xent_library, 3),
        "library_device_ms": device_trace(xent_library, reps=3)["device_ms"],
        "bound_ms": bms, "bound_by": by,
        "shape": {"M": M, "V": V, "d": d}}
    del h, w, labels
    torch.cuda.empty_cache()

    out["gqa_flash_attention"] = time_flash(32, 512, 16, 16, 64)
    # zamba2-2.7b's shared block (head dim 80) at train_zamba2's scoring
    # shape, and grok-1's prefill (GQA 48:8, head dim 128) at serve_moe's
    out["gqa_flash_attention"]["at"] = {
        "zamba2_hd80": time_flash(16, 512, 32, 32, 80),
        "grok1_prefill_hd128": time_flash(8, 512, 48, 8, 128)}

    n, Bs = 1024, 32
    ids = _perm(n, Bs)
    s, w_, seen, idt, losses = score_inputs(n, ids)

    def score_library():
        # the scatter form of Eq. (3.1) (same result for unique ids)
        pos = idt.long()
        s_prev = s[pos]
        w_.index_put_((pos,), 0.2 * s_prev + 0.8 * losses)
        s.index_put_((pos,), 0.9 * s_prev + 0.1 * losses)
        seen.index_put_((pos,), torch.ones_like(idt), accumulate=True)

    out["fused_score_update"] = {
        **time_score(n, ids),
        "library_ms": time_ms(score_library, 50),
        "library_device_ms": device_trace(score_library)["device_ms"],
        # one B = 512 batch over 64 rows of a 2^24-row store, one id, and
        # one full 4,096-id chunk
        "at": {"n2^24_B512_dup64": time_score(1 << 24,
                                              _dup_ids(1 << 24, 512, 64)),
               "n2^24_B1": time_score(1 << 24, [12345]),
               "n2^24_B4096": time_score(1 << 24, _perm(1 << 24, 4096))}}
    del s, w_, seen, idt, losses
    torch.cuda.empty_cache()

    out["segment_sum"], out["segment_sum_grad"] = time_segsum()
    out["fused_quant_score_update"] = time_quant()
    out["quant_grow_scales"] = time_grow(65536)
    out["quant_grow_scales"]["at"] = {"n2^24": time_grow(1 << 24)}
    out["quant_ring_slots"] = time_slots()
    emit({"phase": "time", "kernels": out,
          # the floor of any launch: an empty kernel's device time
          "empty_launch_device_ms": empty_launch_device_ms(),
          "store_update": store_timings(),
          "card": smi_line()})
    return out


def time_flash(B: int, S: int, H: int, K: int, hd: int) -> dict:
    """The flash kernel at one causal shape: events and device ms, its
    plain version, SDPA (events and device), and the bound of the shape
    (q, k, v read and o written once; 4 hd flops a causal pair)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    q, k, v = flash_inputs(B, S, H, K, hd)
    # SDPA takes (B, heads, S, hd) and repeats the kv heads itself
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if H != K else {}
    pairs = B * H * S * (S + 1) / 2          # causal (query, key) pairs
    flops = 4.0 * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    bms, by = bound(flops, nbytes)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              **gqa)
    row = {"ms": time_ms(lambda: gqa_flash_attention(q, k, v), 20),
           "device_ms": kernel_device_ms(lambda: gqa_flash_attention(q, k, v),
                                         "flash_fwd_kernel"),
           "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v), 5),
           "library_ms": time_ms(library, 20),
           "library_device_ms": device_trace(library)["device_ms"],
           "bound_ms": bms, "bound_by": by,
           "shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd}}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def empty_launch_device_ms() -> float:
    from repro_torch.kernels.score_update.ops import empty_launch
    dev = torch.device("cuda", torch.cuda.current_device())
    return kernel_device_ms(lambda: empty_launch(dev), "empty_kernel",
                            reps=50)


def time_score(n: int, ids) -> dict:
    """The f32 update kernel at one shape: event and device ms, the plain
    version's ms (events) and the bound from this run's ids."""
    from repro_torch.kernels.score_update.ops import fused_score_update
    from repro_torch.kernels.score_update.ref import score_update_ref
    s, w, seen, idt, losses = score_inputs(n, ids)

    def kernel():
        return fused_score_update(s, w, seen, idt, losses, beta1=0.2,
                                  beta2=0.9)

    # ids and losses read once; per distinct in-range id s and seen read,
    # s, w and seen written
    valid = idt[(idt >= 0) & (idt < n)]
    distinct = int(torch.unique(valid).numel())
    bms, by = bound(0.0, idt.shape[0] * 8 + distinct * (2 * 4 + 3 * 4))
    return {"ms": time_ms(kernel, 50),
            "device_ms": kernel_device_ms(kernel, "::score_update_kernel"),
            "launches_per_call": device_trace(kernel)["launches_per_call"],
            "plain_ms": time_ms(lambda: score_update_ref(
                s, w, seen, idt, losses, beta1=0.2, beta2=0.9), 3),
            "bound_ms": bms, "bound_by": by,
            "shape": {"n": n, "B": idt.shape[0], "distinct": distinct}}


def time_grow(n: int, B: int = 32, R: int = 1024, block: int = 1024) -> dict:
    """The grow kernel at path B's shapes: steady (the losses the store's
    scales already fit: nothing grows, nothing is re-coded) and growing
    (the scales put back before each call, so every touched block grows
    and is re-coded), its plain version, and the bound from the steady
    run's data."""
    from repro_torch.kernels.score_update.ops import quant_grow_scales
    from repro_torch.kernels.score_update.ref import quant_grow_scales_ref
    args = quant_inputs(n, B, R, block)
    leaves = [args[i] for i in (0, 1, 3, 4, 5, 6, 7)]
    ids, gids, losses = args[9], args[10], args[11]

    def kernel(x=losses):
        return quant_grow_scales(*leaves, ids, gids, x, beta1=0.2,
                                 beta2=0.9, block=block)

    kernel()                       # fits the scales to these losses
    s0, w0 = leaves[2].clone(), leaves[3].clone()
    big = 50 * losses

    def growing():
        leaves[2].copy_(s0)
        leaves[3].copy_(w0)
        return kernel(big)

    valid = ids[ids >= 0]
    blocks = int(torch.unique(valid // block).numel())
    hits = int(torch.isin(gids[ids >= 0], args[5]).sum())
    # ring ids and stamps read once, the batch's three (B,) inputs, per
    # valid id its s code and per touched block its two scales read
    nbytes = R * 8 + B * 12 + valid.numel() + blocks * 8 + hits * 4
    bms, by = bound(12.0 * valid.numel(), nbytes, PEAK_F32_FLOPS)
    return {"ms": time_ms(kernel, 50),
            "device_ms": kernel_device_ms(kernel, "quant_grow_kernel"),
            "growing_device_ms": kernel_device_ms(growing,
                                                  "quant_grow_kernel"),
            "plain_ms": time_ms(lambda: quant_grow_scales_ref(
                *leaves, ids, gids, losses, beta1=0.2, beta2=0.9,
                block=block), 10),
            "plain_device_ms": device_trace(lambda: quant_grow_scales_ref(
                *leaves, ids, gids, losses, beta1=0.2, beta2=0.9,
                block=block), reps=5)["device_ms"],
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "shape": {"n": n, "B": B, "R": R, "block": block,
                      "touched_blocks": blocks, "ring_hits": hits}}


def time_slots(B: int = 32, R: int = 1024) -> dict:
    """The ring-slot kernel at path B's shapes on a full ring."""
    from repro_torch.kernels.score_update.ops import quant_ring_slots
    from repro_torch.kernels.score_update.ref import quant_ring_slots_ref
    g = _gen(7)
    seq = (1 + torch.randperm(4 * R, device="cuda", generator=g)[:R]
           ).to(torch.int32)
    ids = torch.randint(0, 65536, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    mask = (ids >= 0) & (ids < 65536)
    # stamps and ids read once, slots and stamps written once
    bms, by = bound(0.0, R * 4 + B * 4 + B * 8)
    return {"ms": time_ms(lambda: quant_ring_slots(seq, ids, 65536), 50),
            "device_ms": kernel_device_ms(
                lambda: quant_ring_slots(seq, ids, 65536),
                "quant_ring_slots_kernel"),
            "plain_ms": time_ms(lambda: quant_ring_slots_ref(seq, mask), 20),
            "plain_device_ms": device_trace(
                lambda: quant_ring_slots_ref(seq, mask))["device_ms"],
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "shape": {"B": B, "R": R}}


def store_timings() -> dict:
    """Both stores' update calls through the store API that every tree of
    the port has (``make_store``, ``update``, ``fused_score_update``), so
    ``--store-bench`` times another tree's port the same way: the int8
    update at B = 32, R = 1,024, block 1,024 in the steady state (the
    scales already fit) at n = 65,536 and 2^24, with its device time and
    launches per call, the apply kernel's share, the host clock, and the
    device memory it takes beyond the store; the f32 kernel at the path's
    shape and at B = 512 over 64 rows of 2^24."""
    from repro_torch.core.scores import make_store
    from repro_torch.kernels.score_update.ops import fused_score_update
    out = {}
    for n in (65536, 1 << 24):
        st = make_store(None, quantize=True, block=1024)
        qs = st.init_leaf(n, "cuda")
        g = _gen(11)
        ids = torch.randperm(n, device="cuda", generator=g)[:32].to(
            torch.int32)
        st.update(qs, ids, torch.full((32,), 100.0, device="cuda"), 0.2, 0.9)
        losses = 3 * torch.rand(32, device="cuda", generator=g)
        scales = qs.s_scale.clone(), qs.w_scale.clone()

        def update():
            return st.update(qs, ids, losses, 0.2, 0.9)

        trace = device_trace(update)
        if not (torch.equal(scales[0], qs.s_scale)
                and torch.equal(scales[1], qs.w_scale)):
            raise AssertionError("store timing: a scale grew")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        update()
        torch.cuda.synchronize()
        out[f"int8_update_n{n}"] = {
            "device_ms": trace["device_ms"],
            "launches_per_call": trace["launches_per_call"],
            "apply_kernel_device_ms": kernel_device_ms(
                update, "quant_score_update_kernel"),
            "ms": time_ms(update, 50),
            "host_ms": wall_ms(update, 50, warmup=2),
            "temp_bytes": torch.cuda.max_memory_allocated() - base}
        del st, qs
        torch.cuda.empty_cache()
    for name, n, ids in (("f32_n1024_B32", 1024, _perm(1024, 32)),
                         ("f32_n2^24_B512_dup64", 1 << 24,
                          _dup_ids(1 << 24, 512, 64))):
        s, w, seen, idt, losses = score_inputs(n, ids)

        def f32():
            return fused_score_update(s, w, seen, idt, losses, beta1=0.2,
                                      beta2=0.9)

        out[name] = {"device_ms": kernel_device_ms(f32,
                                                   "::score_update_kernel"),
                     "ms": time_ms(f32, 50)}
        del s, w, seen
        torch.cuda.empty_cache()
    return out


# (B, S, M): path A's batch first, then longer rows with more documents,
# 8,192 tokens each
SEGSUM_SHAPES = ((16, 512, 4), (4, 2048, 16), (1, 8192, 64))


def host_ms(fn, reps: int = 200) -> float:
    """Host time of one call: the mean over back-to-back calls with no sync
    between them (the device keeps up: a call's kernels take microseconds,
    its host path tens)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def segsum_tree_timings(refusable: bool = False) -> dict:
    """The segment sum of the port on sys.path at SEGSUM_SHAPES on the
    packed layout, through what every tree of the port has: the forward
    wrapper (events, host time, device time of ``segsum_kernel``), the
    autograd Function's backward alone on a saved context, and forward +
    backward through autograd (events, launches and device time of all
    their device work). With ``refusable`` a forward that raises
    ValueError (a tree whose kernel caps the slots) is reported as
    "refused" (for ``--segsum-bench`` only)."""
    from repro_torch.kernels.segsum import ops
    out = {}
    for B, S, M in SEGSUM_SHAPES:
        nll, seg, mask = packed_segsum_inputs(B, S, M)
        up = torch.rand(B, M, device="cuda", generator=_gen(2)) - 0.5
        ctx = types.SimpleNamespace(saved_tensors=(seg, mask), max_segments=M)
        x = nll.clone().requires_grad_(True)

        def fwd():
            return ops.segment_sum(nll, seg, mask, max_segments=M)

        def bwd():
            return ops._SegmentSum.backward(ctx, up, None)

        def pair():
            x.grad = None
            ops.segment_sum_autograd(x, seg, mask, max_segments=M)[0] \
                .backward(up)

        key = f"B{B}_S{S}_M{M}"
        r = {"backward": {"ms": time_ms(bwd, 50), "host_ms": host_ms(bwd),
                          **device_trace(bwd)}}
        try:
            fwd()
        except ValueError as e:
            if not refusable:
                raise
            out[key] = {"forward": "refused", "autograd": "refused",
                        "reason": str(e), **r}
            continue
        r["forward"] = {"ms": time_ms(fwd, 50), "host_ms": host_ms(fwd),
                        "device_ms": kernel_device_ms(fwd, "segsum_kernel")}
        r["autograd"] = {"ms": time_ms(pair, 50), "host_ms": host_ms(pair),
                         **device_trace(pair)}
        out[key] = r
    return out


def time_segsum() -> tuple:
    """Both segment-sum kernels at SEGSUM_SHAPES: the tree timings above,
    the plain versions, one library call each (the forward: one
    ``scatter_add_`` of the stacked (nll * live, live) pair into M+1 slots,
    sums and counts together; the gradient: one ``gather`` of the
    zero-padded (B, M+1) gradient by a precomputed column index), the
    bounds, and the forward on random ids. Returns the forward's and the
    gradient's entries at path A's shape, the others under "at"."""
    from repro_torch.kernels.segsum.ref import (segment_sum_grad_ref,
                                                segment_sum_ref)
    tree = segsum_tree_timings()
    fwd, grad = {}, {}
    for B, S, M in SEGSUM_SHAPES:
        key = f"B{B}_S{S}_M{M}"
        t = tree[key]
        nll, seg, mask = packed_segsum_inputs(B, S, M)
        up = torch.rand(B, M, device="cuda", generator=_gen(2)) - 0.5
        live = mask & (seg >= 1) & (seg <= M)
        col = torch.where(live, seg, torch.zeros_like(seg)).long()
        pair = torch.stack([nll * live, live.to(torch.float32)], dim=-1)
        col2 = col[..., None].expand(B, S, 2)
        padded = torch.cat([up.new_zeros(B, 1), up], dim=1)

        def library():
            return torch.zeros(B, M + 1, 2, device="cuda").scatter_add_(
                1, col2, pair)

        def grad_library():
            return padded.gather(1, col)

        rnd = segsum_inputs(B, S, M)
        from repro_torch.kernels.segsum.ops import segment_sum
        # a float add and an int add per live token; nll, ids and mask read
        # once, sums and counts written once
        bms, by = bound(2.0 * int(live.sum()), B * S * 9 + 2 * B * M * 4,
                        PEAK_F32_FLOPS)
        fwd[key] = {
            **t["forward"],
            "plain_ms": time_ms(lambda: segment_sum_ref(
                nll, seg, mask, max_segments=M), 20),
            "library_ms": time_ms(library, 50),
            "library_device_ms": device_trace(library)["device_ms"],
            "bound_ms": bms, "bound_by": by,
            "random_ids_device_ms": kernel_device_ms(
                lambda: segment_sum(*rnd, max_segments=M), "segsum_kernel"),
            "shape": {"B": B, "S": S, "M": M}}
        # ids and mask read once, the (B, M) gradient read once, the (B, S)
        # gradient written once
        bms, by = bound(0.0, B * S * 5 + B * M * 4 + B * S * 4)
        grad[key] = {
            **t["backward"],
            "plain_ms": time_ms(lambda: segment_sum_grad_ref(
                up, seg, mask, max_segments=M), 20),
            "library_ms": time_ms(grad_library, 50),
            "library_device_ms": device_trace(grad_library)["device_ms"],
            "bound_ms": bms, "bound_by": by,
            "autograd_pair": t["autograd"],
            "shape": {"B": B, "S": S, "M": M}}
    first = f"B{SEGSUM_SHAPES[0][0]}_S{SEGSUM_SHAPES[0][1]}_M" \
            f"{SEGSUM_SHAPES[0][2]}"
    fwd[first]["at"] = {k: v for k, v in fwd.items() if k != first}
    grad[first]["at"] = {k: v for k, v in grad.items() if k != first}
    return fwd[first], grad[first]


def time_quant() -> dict:
    """Path B's shapes: n = 65,536 rows in blocks of 1,024, B = 32 ids, a
    1,024-slot ring."""
    from repro_torch.core.scores import QuantizedScores, _q_apply_fixed
    from repro_torch.kernels.score_update.ops import fused_quant_score_update
    from repro_torch.kernels.score_update.ref import quant_score_update_ref
    n, B, R, block = 65536, 32, 1024, 1024
    args = quant_inputs(n, B, R, block)
    ids, gids, slots = args[9], args[10], args[12]
    valid = (ids >= 0) & (ids < n)
    qs = QuantizedScores(*args[:9])
    pos = torch.where(valid, ids, torch.zeros_like(ids))

    def library():
        # the store's scatter form of the same update (--no-fused-scores)
        return _q_apply_fixed(qs, pos, valid, gids, args[11], 0.2, 0.9,
                              block, slots, args[13])

    # ring ids and stamps read once; per live id its five (B,) inputs,
    # three codes read and written, two scales, the residual of a ring hit
    # and the four ring words written when its slot is below R
    n_valid = int(valid.sum())
    hits = int(torch.isin(gids[valid], args[5]).sum())
    writes = int((valid & (slots < R)).sum())
    nbytes = R * 8 + B * 20 + n_valid * (3 + 3 + 8) + hits * 4 + writes * 16
    flops = 12.0 * n_valid
    bms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    return {
        "ms": time_ms(lambda: fused_quant_score_update(
            *args, beta1=0.2, beta2=0.9, block=block), 50),
        "device_ms": kernel_device_ms(lambda: fused_quant_score_update(
            *args, beta1=0.2, beta2=0.9, block=block),
            "quant_score_update_kernel"),
        "plain_ms": time_ms(lambda: quant_score_update_ref(
            *args, beta1=0.2, beta2=0.9, block=block), 3),
        "library_ms": time_ms(library, 20),
        "library_device_ms": device_trace(library)["device_ms"],
        "bound_ms": bms, "bound_by": by,
        "shape": {"n": n, "B": B, "R": R, "block": block,
                  "valid": n_valid, "ring_hits": hits, "ring_writes": writes}}


KERNELS = {
    "fused_score_update": {
        "route": "cuda", "source": "src/repro_torch/csrc/score_update.cu",
        "replaces": "src/repro/kernels/score_update/score_update.py:72"},
    "fused_xent": {
        "route": "cuda", "source": "src/repro_torch/csrc/xent.cu",
        "replaces": "src/repro/kernels/xent/xent.py:74"},
    "gqa_flash_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:90"},
    "segment_sum": {
        "route": "cuda", "source": "src/repro_torch/csrc/segsum.cu",
        "replaces": "src/repro/kernels/segsum/segsum.py:57"},
    # the XLA gradient of the reference's one-hot einsum (the TPU has no
    # Pallas backward for the segment sum)
    "segment_sum_grad": {
        "route": "cuda", "source": "src/repro_torch/csrc/segsum.cu",
        "replaces": "src/repro/models/losses.py:107"},
    "fused_quant_score_update": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/quant_score_update.cu",
        "replaces": "src/repro/kernels/score_update/score_update.py:186"},
    # the XLA prologue of the reference's int8 update (no Pallas kernel of
    # its own), which feeds the kernel at score_update.py:186
    "quant_grow_scales": {
        "route": "cuda", "source": "src/repro_torch/csrc/quant_prologue.cu",
        "replaces": "src/repro/core/scores.py:717"},
    "quant_ring_slots": {
        "route": "cuda", "source": "src/repro_torch/csrc/quant_prologue.cu",
        "replaces": "src/repro/core/scores.py:752"},
}


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.score_update.ops import (
        fused_quant_score_update, fused_score_update, quant_grow_scales,
        quant_ring_slots)
    from repro_torch.kernels.segsum.ops import segment_sum, segment_sum_grad
    from repro_torch.kernels.xent.ops import fused_xent
    return {"fused_score_update": fused_score_update,
            "fused_xent": fused_xent,
            "gqa_flash_attention": gqa_flash_attention,
            "segment_sum": segment_sum,
            "segment_sum_grad": segment_sum_grad,
            "fused_quant_score_update": fused_quant_score_update,
            "quant_grow_scales": quant_grow_scales,
            "quant_ring_slots": quant_ring_slots}


# ---------------------------------------------------------------------------
# phase 5: the scoring forward against the training forward, full width
# ---------------------------------------------------------------------------

def phase_model() -> None:
    """Per-sample losses of full-width qwen1.5-0.5b on a small batch: the
    scoring forward (flash + xent kernels) against the training forward
    (plain PyTorch) on the same random weights, within the bf16 tolerance
    the JAX tests use (5e-2)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm, lm_per_sample_loss
    cfg = get_config("qwen1.5-0.5b")
    params = init_lm(cfg, _gen(0), "cuda")
    g = _gen(1)
    tokens = torch.randint(0, 64, (2, 512), device="cuda", generator=g,
                           dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    batch = {"tokens": tokens, "labels": labels}
    with torch.no_grad():
        fast, _ = lm_per_sample_loss(cfg, params, batch, scoring=True)
        slow, _ = lm_per_sample_loss(cfg, params, batch, scoring=False)
    torch.cuda.synchronize()
    err = (fast - slow).abs().max().item()
    ok = bool(torch.isfinite(fast).all()) and fast.shape == (2,)
    emit({"phase": "model", "scoring_loss": fast.tolist(),
          "training_loss": slow.tolist(), "max_abs_err": err})
    if not (ok and err <= 5e-2):
        raise AssertionError(f"scoring vs training forward: {err}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the trainer's paths, full width, through the trainer the CLI builds
# ---------------------------------------------------------------------------

PATH_ARGS = {"train": TRAIN_ARGS, "train_packed": PACK_ARGS,
             "train_quant": QUANT_ARGS, "train_packed_m16": PACK16_ARGS,
             "train_pipelined": PIPELINED_ARGS, "train_drift": DRIFT_ARGS,
             "train_long": LONG_ARGS, "train_packed_mb32": PACK32_ARGS,
             "train_eswp": ESWP_ARGS, "train_infobatch": INFOBATCH_ARGS,
             "train_packed_eswp": PACKED_ESWP_ARGS}


def _steps(args) -> int:
    """The path's step count: its last ``--max-steps``."""
    rev = args[::-1]
    return int(rev[rev.index("--max-steps") - 1])


def phase_path(name: str, args=None, watch=None) -> dict:
    """Run one path through the trainer the CLI builds (``Trainer.train``)
    with every launch count set to 0 just before and read just after.
    ``args`` replaces the path's own; ``watch(tr)``, called on the built
    trainer, returns a check called as ``check(tr, out)`` after the run."""
    args = args or PATH_ARGS[name]
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _trainer(args)
    check = watch(tr) if watch else None
    for fn in wrappers.values():
        fn.launches = 0
    out = tr.train()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    losses = [r["loss"] for r in out["metrics"]]
    steps = [r["step_time"] * 1e3 for r in out["metrics"]]
    # the step cap, or the epochs' lengths as the sampler re-read them
    n_steps = min(_steps(args), sum(e["steps_per_epoch"]
                                    for e in out["epoch_log"]))
    units = path_units(name, n_steps, out)
    emit({"phase": name, "args": args, "losses": losses,
          "bp_samples_total": out["bp_samples_total"],
          "scoring_steps_total": out["scoring_steps_total"],
          "step_ms": steps, "median_step_ms": statistics.median(steps),
          "median_step_ms_after_first": statistics.median(steps[1:]),
          "median_data_wait_ms": statistics.median(
              r["data_wait"] * 1e3 for r in out["metrics"]),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "epoch_log": out["epoch_log"], "prune_events": out["prune_events"],
          "launches": launches, "units": units, "card": smi_line()})
    if out["steps"] != n_steps or len(losses) != n_steps:
        raise AssertionError(f"{name}: trainer ran {out['steps']} steps, "
                             f"expected {n_steps}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    # every scoring leg of a serial path is a counted scoring step (the
    # prime's included); a path whose unit launches no xent runs no
    # scoring forward and counts none: packed ES (scoring rides the
    # training forward) and baseline steps (set-level methods)
    scored = "fused_xent" in PER_UNIT[name]
    if out["scoring_steps_total"] != (units if scored else 0) \
            or not 1 <= units <= n_steps + 1:
        raise AssertionError(f"{name}: {out['scoring_steps_total']} scoring "
                             f"steps over {units} units")
    for k in wrappers:
        want = PER_UNIT[name].get(k, 0) * units
        if launches[k] != want:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"over {units} units, expected {want}")
    if name in PRUNE_PATHS:
        check_pruning(name, tr, out)
    if check:
        check(tr, out)
    del tr
    torch.cuda.empty_cache()
    return launches


PRUNE_PATHS = ("train_eswp", "train_infobatch", "train_packed_eswp")


def reference_prune_events(tr, out) -> list:
    """The prune decisions the reference's rules give for the drift each
    event read (``src/repro/launch/train.py:397-435``,
    ``src/repro/core/engine.py:712-735``): one before each epoch in the
    annealing window; the first is "first-prune", then the epoch cadence
    always prunes, and the drift cadence once the gap reaches the max
    interval or the drift reaches the floor; an epoch counts itself."""
    cad = tr.engine.cadence
    since, pruned, want = 0, False, []
    for ev in out["prune_events"]:
        since += 1
        if not pruned:
            fired, reason = True, "first-prune"
        elif cad.prune_kind == "epoch":
            fired, reason = True, "epoch-cadence"
        elif since >= cad.prune_max_interval:
            fired, reason = True, "max-interval"
        elif ev["since_prune_drift"] >= cad.prune_drift_floor:
            fired, reason = True, "drift"
        else:
            fired, reason = False, "drift-below-floor"
        want.append({"epoch": ev["epoch"], "fired": fired,
                     "reason": reason, "epochs_since_prune": since,
                     "since_prune_drift": ev["since_prune_drift"]})
        if fired:
            since, pruned = 0, True
    return want


def check_pruning(name: str, tr, out) -> None:
    """A pruned path's decisions, kept-set and horizon: the prune events
    the reference's rules give, one an epoch; ESWP's kept-set of
    round(0.8 n) (rows, or documents inside rows); each epoch's step
    count as the sampler gives it; InfoBatch's second epoch trained with
    grad scales of 1/(1-r), and the engine's weighted mean on such a batch
    differs from the unweighted one."""
    tc = tr.tc
    events = out["prune_events"]
    if [e["epoch"] for e in events] != list(range(tc.epochs)) \
            or events != reference_prune_events(tr, out):
        raise AssertionError(f"{name}: prune events {events}")
    n_keep = round((1.0 - tc.pruning_ratio) * tr.n_train)
    last = out["epoch_log"][-1]
    if last["steps_per_epoch"] != tr.pipeline.steps_per_epoch(
            last["epoch"]):
        raise AssertionError(f"{name}: epoch log {out['epoch_log']}")
    spe = [e["steps_per_epoch"] for e in out["epoch_log"]]
    if tr.doc_level:
        kept = int(tr.source.doc_state_arrays()["doc_kept"].sum())
        ok = kept == n_keep and spe == [len(tr.source) // tc.meta_batch] * 2
    elif tc.method == "eswp":
        kept = len(tr.sampler.kept)
        ok = kept == n_keep and spe == [n_keep // tc.meta_batch] * 2
    else:
        kept = len(tr.sampler.kept)
        gs = tr.sampler.grad_scale
        ok = (spe[0] == tr.n_train // tc.meta_batch and kept < tr.n_train
              and spe[1] == kept // tc.meta_batch
              and bool((gs == 1.0 / (1.0 - tc.pruning_ratio)).any()))
        # the second epoch's first batch that holds a rescaled sample
        step = next(i for i in range(spe[1]) if (tr.sampler.grad_scale_for(
            tr.sampler.batch_ids(1, i)) != 1.0).any())
        batch = tr._place(tr.pipeline.batch_at(1, step))
        mean, per_sample, _ = tr.engine._loss_and_grads(tr.state.params,
                                                        batch)
        weighted = float(mean)
        plain = float(per_sample.mean())
        emit({"phase": f"{name}_grad_scale", "batch_scales":
              batch["grad_scale"].tolist(), "weighted_mean": weighted,
              "unweighted_mean": plain})
        ok = ok and bool((batch["grad_scale"] != 1.0).any()) \
            and weighted != plain
    emit({"phase": f"{name}_kept", "kept": kept, "n": tr.n_train,
          "steps_per_epoch": spe, "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: kept {kept} of {tr.n_train}, steps "
                             f"per epoch {spe}")


# ---------------------------------------------------------------------------
# phase 6b: serving, the online service, a token file over two hosts
# ---------------------------------------------------------------------------

SERVE_B, SERVE_P, SERVE_GEN = 8, 512, 64
TEACHER_STEPS = 4          # teacher-forced decode steps held to the forward
# the scoring forward's bf16 tolerance (phase 5), per logit: the logits are
# a bf16 product, so two forwards that differ in rounding differ by whole
# bf16 ulps of each logit: |err| <= MODEL_TOL * max(1, |logit|)
MODEL_TOL = 5e-2


def logit_errs(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |err|, max |err| / max(1, |want|)) of two logit tensors."""
    err = (got - want).abs()
    return (err.max().item(),
            (err / want.abs().clamp_min(1.0)).max().item())


@contextlib.contextmanager
def plain_attention():
    """The prefill's attention through the flash kernel's plain version
    (``kernels/flash_attn/ref.py``) on the card: the plain prefill that
    the kernel's is held to."""
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.models import attention
    kernel = attention.gqa_flash_attention
    attention.gqa_flash_attention = flash_attention_ref
    try:
        yield
    finally:
        attention.gqa_flash_attention = kernel


@contextlib.contextmanager
def flash_inputs_of(record: list):
    """Keep the (q, k, v) of every flash-kernel call made inside."""
    from repro_torch.models import attention
    kernel = attention.gqa_flash_attention

    def spy(q, k, v, **kw):
        record.append((q, k, v))
        return kernel(q, k, v, **kw)
    attention.gqa_flash_attention = spy
    try:
        yield
    finally:
        attention.gqa_flash_attention = kernel


@contextlib.contextmanager
def moe_routes(record: list, replay: bool = False):
    """Record each MoE call's expert choices in call order (``replay``:
    hand them back, in the same order, to a second run of the same
    forward). A bf16 near-tie of two router logits is a discontinuity of
    the model: a last-ulp difference of attention upstream swaps an
    expert, and the token's output with it. Replaying the first run's
    choices holds two forwards to each other where they route alike."""
    from repro_torch.models import moe
    inner = moe._top_k
    pending = iter(list(record)) if replay else None

    def spy(logits, k):
        if replay:
            idx = next(pending)
            return logits.gather(-1, idx), idx
        vals, idx = inner(logits, k)
        record.append(idx)
        return vals, idx
    moe._top_k = spy
    try:
        yield
    finally:
        moe._top_k = inner


def _expect(what: str, got: dict, want: dict) -> None:
    """Every wrapper's launches in ``got`` as ``want`` says (absent: 0)."""
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {bad}, expected {want}")


def phase_serve(name: str = "serve", cfg=None, gen: int = SERVE_GEN,
                expect=None, check_cfg=None, exact: bool = False,
                hold_logits: bool = True) -> dict:
    """``Server.generate`` on ``cfg`` (full-width qwen1.5-0.5b by default):
    batch 8, prompts of 512 tokens, ``gen`` greedy tokens. The whole
    ``generate`` launches ``expect`` (by default the flash kernel once a
    layer, in the prefill) and nothing else. Its prefill's logits are held
    to the plain prefill's on the card, and a few teacher-forced decode
    steps to the full (training-path) forward over the same prefix, both
    on ``check_cfg`` (``cfg`` by default; a MoE is held with a dropless
    capacity, where one-token decode routes as the full forward does;
    the plain prefill takes the kernel's routes, ``moe_routes``). With
    ``exact`` the teacher-forced steps are held in float32 compute, over
    a float32 cache that the plain prefill fills (the flash kernel takes
    bf16 only), as ``tests/test_decode.py`` holds the reference: in bf16
    an SSM's forward and decode round at other places (bf16 conv weights
    and activations against float32 ones) and a MoE's routing flips at
    near-ties, so their bf16 gaps are reported, not held. The flash
    kernel is also held to its plain version on the very (q, k, v) of
    each of the prefill's layers. ``hold_logits`` False (a MoE at
    published widths: the experts' gain at random init amplifies the two
    attentions' last-ulp differences past the bound, routes pinned or
    not) reports the prefill's logit gap instead of holding it. Times: the prefill alone, the whole ``generate`` (host clock to a
    device sync), the decode's ms a token from the two, tokens/s, peak
    memory, and the device time and launches of one prefill and of one
    decode step (torch.profiler)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import unembed_matrix
    from repro_torch.models.losses import last_token_logits
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.transformer import lm_hidden, tree_leaves
    cfg = cfg or get_config("qwen1.5-0.5b")
    ccfg = check_cfg or cfg
    expect = {"gqa_flash_attention": cfg.num_layers} if expect is None \
        else expect
    B, P, G = SERVE_B, SERVE_P, gen
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = Server(cfg, device="cuda", seed=0)
    params = server.params
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=_gen(7),
                            device="cuda", dtype=torch.int32).cpu().numpy()
    for fn in wrappers.values():
        fn.launches = 0
    out = server.generate(prompts, G)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    _expect(name, launches, expect)
    if out.shape != (B, P + G) or not ((out >= 0)
                                       & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{name}: tokens of shape {out.shape}")
    tokens = torch.as_tensor(prompts, device="cuda")

    def run_prefill(c=cfg):
        with torch.no_grad():
            return prefill(c, params, {"tokens": tokens},
                           init_cache(c, B, P + G, device="cuda"))

    prefill_ms = wall_ms(run_prefill, 5)
    gen_ms = wall_ms(lambda: server.generate(prompts, G), 3)
    prefill_trace = device_trace(run_prefill, 5)
    seq = torch.as_tensor(out, device="cuda")

    def teacher_forced(c, cache):
        """TEACHER_STEPS decode steps of ``c`` over ``cache`` against the
        full forward over the same prefix."""
        errs = []
        for t in range(TEACHER_STEPS):
            logits, cache = decode_step(c, params, seq[:, P + t:P + t + 1],
                                        cache, P + t)
            h = lm_hidden(c, params, seq[:, :P + t + 1])
            full = last_token_logits(h[:, -1:],
                                     unembed_matrix(params["embed"]))
            errs.append(logit_errs(logits, full))
            del h, full
        return errs

    with torch.no_grad():
        fast_routes, free_routes, qkv = [], [], []
        with moe_routes(fast_routes), flash_inputs_of(qkv):
            fast, cache = run_prefill(ccfg)
        from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
        from repro_torch.kernels.flash_attn.ref import flash_attention_ref
        layer_errs = []
        for q, k, v in qkv:
            want = flash_attention_ref(q, k, v).float()
            diff = (gqa_flash_attention(q, k, v).float() - want).abs()
            layer_errs.append((diff.max().item(), bool(
                (diff <= FLASH_TOL + FLASH_RTOL * want.abs()).all())))
        del qkv
        with plain_attention(), moe_routes(fast_routes, replay=True):
            plain, _ = run_prefill(ccfg)
        prefill_err = logit_errs(fast, plain)
        routes = {}
        if ccfg.num_experts:
            # the same plain prefill routing on its own
            with plain_attention(), moe_routes(free_routes):
                free, _ = run_prefill(ccfg)
            routes = {"prefill_unpinned_max_rel_err":
                      logit_errs(fast, free)[1],
                      "routes_agree": statistics.mean(
                          (a == b).all(-1).float().mean().item()
                          for a, b in zip(fast_routes, free_routes))}
            del free
        bf16_errs = teacher_forced(ccfg, cache)
        decode_errs = bf16_errs
        if exact:
            import dataclasses
            f32 = dataclasses.replace(ccfg, compute_dtype="float32")
            with plain_attention():
                _, c32 = prefill(f32, params, {"tokens": tokens},
                                 init_cache(f32, B, P + G,
                                            dtype=torch.float32,
                                            device="cuda"))
            decode_errs = teacher_forced(f32, c32)
            del c32
        # one more decode step, rewritten at the same position each call
        pos = torch.full((1,), P + TEACHER_STEPS, dtype=torch.long,
                         device="cuda")
        step_tok = seq[:, P + TEACHER_STEPS:P + TEACHER_STEPS + 1]
        decode_trace = device_trace(
            lambda: decode_step(cfg, params, step_tok, cache, pos), 10)
    torch.cuda.synchronize()
    kv = [x for k, c in cache.items() if k in ("kv", "attn_kv")
          for x in c.values()]
    row = {"phase": name, "arch": cfg.name, "layers": cfg.num_layers,
           "batch": B, "prompt_len": P, "generated": G,
           "launches": launches, "prefill_ms": prefill_ms,
           "generate_ms": gen_ms,
           "decode_ms_per_token": (gen_ms - prefill_ms) / (G - 1),
           "tokens_per_s": B * G / (gen_ms / 1e3),
           "max_memory_allocated": peak,
           "kv_cache_bytes": sum(x.numel() * x.element_size() for x in kv),
           "cache_bytes": sum(x.numel() * x.element_size()
                              for c in cache.values() for x in c.values()),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "check_capacity_factor": ccfg.capacity_factor
           if ccfg.num_experts else None,
           "prefill_trace": prefill_trace, "decode_trace": decode_trace,
           "prefill_max_abs_err": prefill_err[0],
           "prefill_max_rel_err": prefill_err[1],
           "decode_max_abs_err": [e[0] for e in decode_errs],
           "decode_max_rel_err": [e[1] for e in decode_errs],
           "decode_held_in": "float32" if exact else ccfg.compute_dtype,
           "decode_bf16_max_rel_err": [e[1] for e in bf16_errs], **routes,
           "prefill_logits_held": hold_logits,
           "prefill_flash_max_abs_err": max((e[0] for e in layer_errs),
                                            default=None),
           "finite": bool(torch.isfinite(fast).all()),
           "sample_output": out[0, P:P + 8].tolist(), "card": smi_line()}
    emit(row)
    held = [*decode_errs, prefill_err] if hold_logits else decode_errs
    if not (row["finite"] and max(e[1] for e in held) <= MODEL_TOL
            and all(ok for _, ok in layer_errs)
            and len(layer_errs) == expect.get("gqa_flash_attention", 0)):
        raise AssertionError(f"{name}: prefill {prefill_err}, decode "
                             f"{decode_errs} against {MODEL_TOL}, flash on "
                             f"the prefill's inputs {layer_errs}")
    del server, params, cache, fast, plain
    torch.cuda.empty_cache()
    return launches


# the service's CLI at full width: 256 synthetic samples of 512, 2 epochs
# of meta-batch 32, 8 candidates every 2 steps, each drain of 8 scored on
# the live weights and admitted against tau = 1
SERVICE_ARGV = ["--arch", "qwen1.5-0.5b", "--full", "--epochs", "2",
                "--n-samples", "256", "--seq-len", "512", "--meta-batch",
                "32", "--minibatch", "8", "--tau", "1.0", "--max-batch", "8",
                "--submit-every", "2", "--submit-batch", "8", "--device",
                "cuda"]
# a drain: the candidates' scoring forward, and the install of the
# admitted rows' losses (none when nothing is admitted)
DRAIN = {"gqa_flash_attention": 24, "fused_xent": 1}


def phase_service() -> dict:
    """The online service over a StreamingSource: each drain's launches
    (the scoring forward; one f32 score update when it admits), the grown
    store, sampler and source, epoch 1's step count over the rows admitted
    in epoch 0, the admitted rows' ``seen``, and a decode from the live
    weights at the end. Reports the admission latency."""
    from repro_torch.launch import service
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = service.build_parser().parse_args(SERVICE_ARGV)
    tr, svc, tok, lab = service.build(args)
    n0, mb = args.n_samples, args.meta_batch
    drains, marks = [], []
    score, apply = svc.admission.score_fn, svc._apply

    def score_fn(tokens, labels):
        marks.append({k: w.launches for k, w in wrappers.items()})
        return score(tokens, labels)

    def apply_fn(res):
        n = apply(res)
        drains.append({"epoch": svc._cur_epoch, "step": tr.global_step,
                       "admitted": n, "launches": {
                           k: w.launches - marks[-1][k]
                           for k, w in wrappers.items()}})
        return n

    svc.admission.score_fn, svc._apply = score_fn, apply_fn
    service.feed(svc, tok, lab, args.submit_every, args.submit_batch)
    for fn in wrappers.values():
        fn.launches = 0
    out = tr.train()
    svc.flush()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for d in drains:
        _expect(f"service drain at step {d['step']}", d["launches"],
                {**DRAIN, "fused_score_update": int(d["admitted"] > 0)})
    steps = out["steps"]
    want = {k: SCORING_LEG.get(k, 0) * steps + sum(
        d["launches"][k] for d in drains) for k in wrappers}
    _expect("service", launches, want)
    n_adm = svc.admission.admitted
    n0_adm = sum(d["admitted"] for d in drains if d["epoch"] == 0)
    spe = [e["steps_per_epoch"] for e in out["epoch_log"]]
    sizes = (tr.n_train, tr.es_cfg.n_train, tr.state.scores.s.shape[0],
             tr.sampler.n_samples, len(tr.source))
    seen = tr.state.scores.seen[n0:]
    losses = [r["loss"] for r in out["metrics"]]
    live = svc.server.params is tr.state.params
    dec = svc.decode(tok[:2, :16], 8)
    stats = svc.admission.latency_stats()
    emit({"phase": "service", "argv": SERVICE_ARGV, "steps": steps,
          "steps_per_epoch": spe, "submitted": svc.admission.submitted,
          "admitted": n_adm, "admitted_epoch0": n0_adm, "rows": sizes,
          "drains": drains, "admit_log": svc.admit_log,
          "launches": launches, "losses": losses,
          "step_ms": [r["step_time"] * 1e3 for r in out["metrics"]],
          "live_weights": live, "decode_shape": list(dec.shape),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **stats, "card": smi_line()})
    if len(drains) < 4 or sizes != (n0 + n_adm,) * 5 or \
            tr.sampler.population(1) != n0 + n0_adm or \
            spe != [n0 // mb, (n0 + n0_adm) // mb] or \
            steps != sum(spe) or not bool((seen >= 1).all()) or \
            not all(map(math.isfinite, losses)) or not live or \
            dec.shape != (2, 24):
        raise AssertionError(f"service: {len(drains)} drains, rows "
                             f"{sizes}, steps {spe}, live {live}")
    del tr, svc
    torch.cuda.empty_cache()
    return launches


# S1's shape from a token file, as host 1 of 2 (16 of each 32 rows)
TOKENS_ARGS = TRAIN_ARGS + ["--source", "tokens", "--num-hosts", "2",
                            "--host-id", "1"]


def phase_train_tokens() -> dict:
    """Path ``train_tokens``: S1's synthetic samples (64-token vocabulary)
    written as one uint16 token file in a temporary directory, trained
    from it as host 1 of 2: each step's sample ids must be the second
    half of the sampler's global meta-batch."""
    import tempfile

    import numpy as np
    from repro_torch.data.pipeline import SyntheticSource, write_token_bin
    n, S = 1024, 512
    src = SyntheticSource(n_samples=n, seq_len=S, vocab_size=64, seed=0)
    flat = src.batch(np.arange(n))["tokens"].reshape(-1)
    with tempfile.TemporaryDirectory() as d:
        path = write_token_bin(Path(d) / "corpus.bin",
                               np.concatenate([flat, flat[:1]]))

        def watch(tr):
            seen = []
            inner = tr.engine.session

            def session(*a, **k):
                sess = inner(*a, **k)
                step = sess.step

                def spy(state, batch):
                    seen.append(batch["sample_ids"].cpu().numpy().copy())
                    return step(state, batch)
                sess.step = spy
                return sess
            tr.engine.session = session

            def check(tr, out):
                half = tr.tc.meta_batch // 2
                for b, ids in enumerate(seen):
                    glob = tr.sampler.batch_ids(0, b)
                    if not np.array_equal(ids, glob[half:]):
                        raise AssertionError(f"train_tokens step {b}: ids "
                                             f"not host 1's half")
                if (tr.host_id, tr.num_hosts) != (1, 2) or \
                        len(seen) != out["steps"] or len(tr.source) != n:
                    raise AssertionError("train_tokens: hosts or steps")
            return check

        return phase_path("train_tokens",
                          TOKENS_ARGS + ["--data-path", str(path)], watch)


# ---------------------------------------------------------------------------
# phase 6c: --grad-compression, and the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

def _es_args(arch: str, meta: int, mini: int, full: bool = True) -> list:
    """Serial ES at sequence 512 over 1,024 synthetic samples, 4 steps."""
    return ["--arch", arch, *(["--full"] if full else []), "--method",
            "es", "--seq-len", "512", "--max-steps", "4", "--device",
            "cuda", "--meta-batch", str(meta), "--minibatch", str(mini),
            "--n-samples", "1024"]


# mamba2-780m at its published widths and depth (48 layers, d 1,536, state
# 128, vocab 50,304): S1's traffic; no attention, so no flash launch
MAMBA2_ARGS = _es_args("mamba2-780m", 32, 8)
# zamba2-2.7b at its published widths and depth (54 Mamba2 layers, d 2,560,
# 9 sites of the shared block with 32 heads of 80, d_ff 10,240)
ZAMBA2_ARGS = _es_args("zamba2-2.7b", 16, 4)
# arctic's smoke config (8 experts top-2, a dense residual, bf16 weights):
# the MoE step, its routing and its kernels at S1's traffic
MOE_ARGS = _es_args("arctic-480b", 32, 8, full=False)
# S1 with int8 gradient compression and error feedback
GC_ARGS = TRAIN_ARGS + ["--grad-compression"]
FAMILY_ARGS = {"train_mamba2": MAMBA2_ARGS, "train_zamba2": ZAMBA2_ARGS,
               "train_moe": MOE_ARGS, "train_gc": GC_ARGS}


def scoring_watch(tr):
    """A ``phase_path`` watch: the first scoring leg's per-sample losses
    (the kernels' forward) against the plain forward (``scoring=False``
    under no_grad) on the same batch and weights, taken inside the leg,
    before the step updates the weights; the plain forward launches no
    kernel. After the run, the scoring and training legs of one more step
    (``family_legs``)."""
    from repro_torch.core import engine
    inner = engine.lm_per_sample_loss
    rec = {}

    def spy(cfg, params, batch, *, scoring=False, **kw):
        out = inner(cfg, params, batch, scoring=scoring, **kw)
        if scoring and "err" not in rec:
            with torch.no_grad():
                plain, _ = inner(cfg, params, batch, scoring=False)
            rec["err"] = (out[0] - plain).abs().max().item()
            rec["finite"] = bool(torch.isfinite(out[0]).all())
            rec["losses"] = out[0][:4].tolist()
        return out
    engine.lm_per_sample_loss = spy

    def check(tr, out):
        engine.lm_per_sample_loss = inner
        name = tr.tc.arch + ("" if tr.tc.smoke else " full")
        emit({"phase": "scoring_check", "arch": name, **rec,
              "legs": family_legs(tr), "card": smi_line()})
        if not (rec.get("finite") and rec["err"] <= MODEL_TOL):
            raise AssertionError(f"{name}: scoring forward against the "
                                 f"plain forward: {rec}")
    return check


def family_legs(tr) -> dict:
    """The scoring leg (no-grad forward with the kernels, the store
    update) and the training leg (forward + backward of the minibatch) of
    one serial-ES step at the trainer's shapes: host clock to a device
    sync (median of 3) and device time (torch.profiler, 2 calls)."""
    from repro_torch.core.selection import select_minibatch
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))
    w, _, _ = eng._score_leg(st, batch)
    idx = select_minibatch("es", w, eng.es_cfg.minibatch,
                           generator=st.generator)
    sel = {k: v[idx.long()] for k, v in batch.items()}
    legs = {"scoring": lambda: eng._score_leg(st, batch),
            "training": lambda: eng._loss_and_grads(st.params, sel)}
    out = {}
    for name, fn in legs.items():
        out[name] = {"wall_ms": wall_ms(fn, 3),
                     **device_trace(fn, reps=2)}
    return out


def grad_compression_watch(tr):
    """A ``phase_path`` watch for ``train_gc``: after the run, the
    compression leg (``compress_decompress`` over every gradient leaf, as
    ``ESEngine._optim`` runs it: host clock to a device sync and device
    time), the residuals' bytes, and ``compress_decompress`` of one
    gradient leaf on the card against the same function on a CPU copy,
    bitwise (codes, scales, dequantized values and the new residual)."""
    from repro_torch.distributed.compression import compress_decompress
    from repro_torch.models.transformer import tree_leaves

    def check(tr, out):
        eng, st = tr.engine, tr.state
        batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))
        sel = {k: v[:eng.es_cfg.minibatch] for k, v in batch.items()}
        _, _, grads = eng._loss_and_grads(st.params, sel)
        pairs = list(zip(tree_leaves(grads), tree_leaves(st.grad_err)))

        def leg():
            return [compress_decompress(g, e) for g, e in pairs]
        g, e = grads["layers"]["attn"]["wq"], st.grad_err["layers"]["attn"][
            "wq"]
        got = compress_decompress(g, e)
        want = compress_decompress(g.cpu(), e.cpu())
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        row = {"phase": "grad_compression",
               "leaves": len(pairs),
               "residual_bytes": sum(e.numel() * e.element_size()
                                     for _, e in pairs),
               "residual_nonzero": all(bool(e.any()) for _, e in pairs),
               "leg_wall_ms": wall_ms(leg, 3),
               **{"leg_" + k: v for k, v in device_trace(leg, 2).items()},
               "bitwise_leaf": "layers/attn/wq", "leaf_elements": g.numel(),
               "bitwise_equal": same,
               "max_abs_err": max((a.cpu() - b).abs().max().item()
                                  for a, b in zip(got, want)),
               "card": smi_line()}
        emit(row)
        if not (same and row["residual_nonzero"]):
            raise AssertionError(f"train_gc: {row}")
    return check


FAMILY_WATCH = {"train_mamba2": scoring_watch, "train_zamba2": scoring_watch,
                "train_moe": scoring_watch,
                "train_gc": grad_compression_watch}


def phase_family(name: str) -> dict:
    return phase_path(name, FAMILY_ARGS[name], FAMILY_WATCH[name])


def grok1_cut():
    """grok-1-314b at its published widths (d 6,144, 48 heads of 128 over
    8 kv heads, 8 experts of d_ff 32,768, top-2, vocab 131,072), depth cut
    64 -> 2 layers to fit one card in float32."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("grok-1-314b"), num_layers=2)


def phase_serve_mamba2() -> dict:
    """mamba2-780m at full width: no attention, so the prefill launches
    no kernel (and nothing else does). Decode is held to the forward in
    float32 (``phase_serve``'s ``exact``)."""
    from repro_torch.configs import get_config
    return phase_serve("serve_mamba2", get_config("mamba2-780m"),
                       expect={}, exact=True)


def phase_serve_moe() -> dict:
    """grok-1 at published widths, 2 layers: one flash launch a layer in
    the prefill (hd 128, 48:8). 16 tokens. The checks run with a dropless
    capacity factor (= num_experts): a decode step routes its 8 tokens,
    the full forward 8 x (P + t), and only without drops do the two route
    alike (``tests/test_decode.py:28-35``); the plain prefill takes the
    kernel run's routes and decode is held to the forward in float32
    (``phase_serve``). The prefill's logits differ from the plain
    prefill's by ~0.12 (routes pinned; 0.155 not), past the 5e-2 bound:
    the experts' gain at grok's widths amplifies the attentions' last-ulp
    differences; they are reported, and the kernel is held on the
    prefill's own (q, k, v) of both layers."""
    import dataclasses
    cfg = grok1_cut()
    return phase_serve("serve_moe", cfg, gen=16,
                       expect={"gqa_flash_attention": cfg.num_layers},
                       check_cfg=dataclasses.replace(
                           cfg, capacity_factor=float(cfg.num_experts)),
                       exact=True, hold_logits=False)


# ---------------------------------------------------------------------------
# phase 7: where one step's time goes
# ---------------------------------------------------------------------------

def phase_legs() -> None:
    """Time of each leg of one serial-ES step at the trainer's shapes
    (host clock to a device sync, median of 3), and one whole step under
    torch.profiler: device time by kernel and the device's busy share."""
    from repro_torch.core.selection import select_minibatch
    from repro_torch.optim.adamw import apply_updates
    tr = _trainer(TRAIN_ARGS)
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))
    w, _, _ = eng._score_leg(st, batch)
    b = eng.es_cfg.minibatch
    idx = select_minibatch("es", w, b, generator=st.generator)
    sel = {k: v[idx.long()] for k, v in batch.items()}
    _, _, grads = eng._loss_and_grads(st.params, sel)
    legs = {
        "score_forward_and_store": lambda: eng._score_leg(st, batch),
        "select": lambda: select_minibatch("es", w, b,
                                           generator=st.generator),
        "train_forward_backward": lambda: eng._loss_and_grads(st.params, sel),
        "adamw": lambda: apply_updates(eng.opt_cfg, st.params, grads,
                                       st.opt, 1.0),
        "whole_step": lambda: eng.es_step(st, batch),
    }
    ms = {name: wall_ms(fn, 3) for name, fn in legs.items()}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    # 1 step to start the tracer, then ACTIVE traced steps
    active = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=active)) as prof:
        eng.es_step(st, batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(active):
            eng.es_step(st, batch)
            if i < active - 1:      # a step past the window clears it
                prof.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / active
    # device rows: kernels and copies (the step annotation is not work)
    rows = [(e.self_device_time_total / 1e3 / active, e.count // active,
             e.key[:90]) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not e.key.startswith("ProfilerStep")]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "legs", "leg_ms": ms,
          "legs_sum_ms": sum(v for k, v in ms.items() if k != "whole_step"),
          "traced_step_wall_ms": traced_ms,
          "traced_step_kernel_ms": device_ms,
          "device_busy_share_traced": device_ms / traced_ms,
          "device_busy_share_untraced": device_ms / ms["whole_step"],
          "kernels_per_step": sum(r[1] for r in rows),
          "top_kernels": [{"ms": r[0], "per_step": r[1], "name": r[2]}
                          for r in rows[:25]],
          "card": smi_line()})
    del tr, eng, st, grads
    torch.cuda.empty_cache()


def _trainer(args, model_cfg=None, **tc_fields):
    """The trainer the CLI builds from ``args``, with ``model_cfg`` and
    ``TrainerConfig`` fields overridden."""
    from repro_torch.launch import train
    ns = train.build_parser().parse_args(args)
    fields = set(train.TrainerConfig.__dataclass_fields__)
    return train.Trainer(train.TrainerConfig(
        **{**{k: v for k, v in vars(ns).items() if k in fields},
           **tc_fields}), model_cfg=model_cfg)


def packed_forward_backward():
    """Path A's trainer, its first batch placed on the card, and the packed
    step's training leg on it: one differentiated forward + backward
    (through what every tree of the port has)."""
    from repro_torch.core.engine import _value_and_grad
    from repro_torch.models.transformer import lm_per_segment_loss
    tr = _trainer(PACK_ARGS)
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))

    def fwd_bwd():
        return _value_and_grad(st.params, lambda: (lm_per_segment_loss(
            eng.model_cfg, st.params, batch)[0].mean(), None))

    return tr, batch, fwd_bwd


def forward_backward_trace(fwd_bwd, reps: int = 3) -> dict:
    """Device launches and time per call of the packed forward + backward
    in a padded trace, and the two segment-sum kernels' share."""
    rows = _device_rows(fwd_bwd, reps)
    out = {"launches_per_call": sum(e.count for e in rows) / reps,
           "device_ms": sum(e.self_device_time_total
                            for e in rows) / 1e3 / reps}
    for kernel in ("segsum_kernel", "segsum_grad_kernel"):
        mine = [e for e in rows if kernel in e.key]
        out[kernel] = {"launches_per_call": sum(e.count for e in mine) / reps,
                       "device_ms": sum(e.self_device_time_total
                                        for e in mine) / 1e3 / reps}
    return out


def phase_legs_packed() -> None:
    """Time of the packed step's legs at path A's shapes (host clock to a
    device sync, median of 3): the differentiated forward + backward (the
    segment sum and its gradient inside), the two segment-sum kernels
    alone, the f32 store update over the 64 document slots, AdamW and one
    whole step with its peak memory; the forward + backward's device
    launches and time in a padded trace, with the two segment-sum
    kernels' share. Then the int8 store's update (grow/recode prologue, ring
    slots and kernel) against the f32 kernel at path B's B = 32 and
    n = 65,536, and the kernels each launches per call, under
    torch.profiler."""
    from repro_torch.core.scores import make_store
    from repro_torch.kernels.score_update.ops import (quant_grow_scales,
                                                      quant_ring_slots)
    from repro_torch.kernels.segsum.ops import segment_sum, segment_sum_grad
    from repro_torch.optim.adamw import apply_updates
    tr, batch, fwd_bwd = packed_forward_backward()
    eng, st = tr.engine, tr.state
    _, _, grads = fwd_bwd()
    ids = batch["doc_ids"].reshape(-1)
    losses = 3 * torch.rand(ids.shape[0], device="cuda", generator=_gen(3))
    nll = 5 * torch.rand(batch["labels"].shape, device="cuda",
                         generator=_gen(4))
    seg = batch["segment_ids"].contiguous()
    live = (batch["labels"] != -1).contiguous()
    up = torch.rand(nll.shape[0], 4, device="cuda", generator=_gen(6))
    legs = {
        "forward_backward": fwd_bwd,
        "segment_sum": lambda: segment_sum(nll, seg, live, max_segments=4),
        "segment_sum_grad": lambda: segment_sum_grad(up, seg, live,
                                                     max_segments=4),
        "store_update": lambda: eng.store.update(st.scores, ids, losses, 0.2,
                                                 0.9),
        "adamw": lambda: apply_updates(eng.opt_cfg, st.params, grads, st.opt,
                                       1.0),
        "whole_step": lambda: eng.packed_step(st, batch),
    }
    ms = {name: wall_ms(fn, 3) for name, fn in legs.items()}
    fb_trace = forward_backward_trace(fwd_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.packed_step(st, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del tr, eng, st, grads, batch
    torch.cuda.empty_cache()

    n, B, block = 65536, 32, 1024
    g = _gen(5)
    sid = torch.randperm(n, device="cuda", generator=g)[:B].to(torch.int32)
    sl = 3 * torch.rand(B, device="cuda", generator=g)
    f32, quant = make_store(None), make_store(None, quantize=True,
                                              block=block)
    fs, qs = f32.init_leaf(n, "cuda"), quant.init_leaf(n, "cuda")

    def prologue():
        quant_grow_scales(qs.s_q, qs.w_q, qs.s_scale, qs.w_scale,
                          qs.err_rows, qs.err_seq, qs.err_s, sid, sid, sl,
                          beta1=0.2, beta2=0.9, block=block)
        return quant_ring_slots(qs.err_seq, sid, n)

    store = {
        "f32_update": lambda: f32.update(fs, sid, sl, 0.2, 0.9),
        "int8_update": lambda: quant.update(qs, sid, sl, 0.2, 0.9),
        "int8_prologue": prologue,
    }
    store_ms = {k: wall_ms(fn, 20, warmup=2) for k, fn in store.items()}
    trace = {k: device_trace(fn) for k, fn in store.items()}
    emit({"phase": "legs_packed", "args": PACK_ARGS, "leg_ms": ms,
          "legs_sum_ms": sum(v for k, v in ms.items()
                             if k not in ("whole_step", "segment_sum",
                                          "segment_sum_grad")),
          "forward_backward_trace": fb_trace,
          "whole_step_peak_memory": peak,
          "store_update_ms": store_ms, "store_update_trace": trace,
          "store_shape": {"n": n, "B": B, "block": block},
          "card": smi_line()})


# ---------------------------------------------------------------------------
# phase 8: the data layer (host build, pin and copy, the consumer's stall)
# ---------------------------------------------------------------------------

def _median_ms(fn, reps: int) -> float:
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _step_device_ms(args) -> float:
    """Device time of one trained step of ``args``'s step function (serial
    ES or packed), from torch.profiler over 3 steps."""
    tr = _trainer(args)
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.pipeline.batch_at(0, 0))
    step = eng.packed_step if tr.doc_level else eng.es_step
    ms = device_trace(lambda: step(st, batch), reps=3)["device_ms"]
    del tr, eng, st, batch
    torch.cuda.empty_cache()
    return ms


def _trainer_run(args) -> dict:
    """One trainer run: median step and consumer stall after the first
    step, in ms."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    out = train.main(args)
    torch.cuda.synchronize()
    rest = out["metrics"][1:]
    return {"median_step_ms": statistics.median(r["step_time"] * 1e3
                                                for r in rest),
            "median_data_wait_ms": statistics.median(r["data_wait"] * 1e3
                                                     for r in rest),
            "max_data_wait_ms": max(r["data_wait"] * 1e3 for r in rest)}


def phase_data() -> None:
    """The data layer at the two batch shapes of the paths: the synthetic
    32 x 512 meta-batch and the packed 16 x 512 x 4 one. Host ms to build
    a batch (numpy), to pin it, and to pin and copy it to the card (the
    trainer's CUDA placer, to a device sync); then the trainer with
    prefetch on and off, in turns (on, off, off, on), 10 steps each: the
    median step, the consumer's stall in next() and the untraced device
    busy share (device time of a step, profiled, over the median step)."""
    from repro_torch.data.pipeline import CudaPlacer
    placer = CudaPlacer("cuda")
    rows = {}
    for name, args in (("synthetic", TRAIN_ARGS), ("packed", PACK_ARGS)):
        tr = _trainer(args)
        source, pipe = tr.source, tr.pipeline
        hosts = [pipe.batch_at(0, i) for i in range(10)]
        del tr
        torch.cuda.empty_cache()
        row = {
            "batch_shape": list(hosts[0]["tokens"].shape),
            "bytes": sum(v.nbytes for v in hosts[0].values()),
            "host_build_ms": _median_ms(
                lambda i: source.batch(pipe.sampler.batch_ids(0, i)), 10),
            "pin_ms": _median_ms(lambda i: [
                torch.from_numpy(v).pin_memory()
                for v in hosts[i].values()], 10),
        }

        def pin_and_copy(i):
            placer.ready(placer(hosts[i]))
            torch.cuda.synchronize()

        row["pin_and_copy_ms"] = _median_ms(pin_and_copy, 10)
        run_args = args + ["--max-steps", "10"]
        runs = [(p, _trainer_run(run_args + ([] if p else ["--no-prefetch"])))
                for p in (True, False, False, True)]
        device_ms = _step_device_ms(args)
        row["device_ms_per_step"] = device_ms
        for p, key in ((True, "prefetch_on"), (False, "prefetch_off")):
            mine = [r for q, r in runs if q == p]
            row[key] = [{**r, "busy_share_untraced":
                         device_ms / r["median_step_ms"]} for r in mine]
        rows[name] = row
    emit({"phase": "data", "rows": rows, "card": smi_line()})


# ---------------------------------------------------------------------------
# phase 9: pipelined ES on two streams against the serial step
# ---------------------------------------------------------------------------

SCORING_KERNELS = ("flash_fwd_kernel", "xent_partials_kernel",
                   "xent_combine_kernel", "score_update_kernel")


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _measure(intervals: list) -> float:
    return sum(b - a for a, b in intervals)


def _intersect(xs: list, ys: list) -> float:
    """Measure of the intersection of two unions of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_trace(fn) -> dict:
    """One call of ``fn`` under torch.profiler (after one in the tracer's
    warm-up step), read from its Chrome trace: device kernels per CUDA
    stream (count, device ms), the streams of the scoring kernels, and
    the device time in which two streams ran kernels at once."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    per = {}
    for e in kernels:
        per.setdefault(e["args"]["stream"], []).append(e)
    unions = {sid: _union([[e["ts"], e["ts"] + e["dur"]] for e in evs])
              for sid, evs in per.items()}
    overlap = 0.0
    sids = sorted(unions)
    for i, a in enumerate(sids):
        for b in sids[i + 1:]:
            overlap += _intersect(unions[a], unions[b])
    every = _union([iv for u in unions.values() for iv in u])
    # the window the scoring leg spans (first to last scoring-stream
    # kernel) and the device time inside it
    scoring_sids = {e["args"]["stream"] for e in kernels
                    if any(k in e["name"] for k in SCORING_KERNELS)}
    window = [[min(u[0][0] for sid, u in unions.items()
                   if sid in scoring_sids),
               max(u[-1][1] for sid, u in unions.items()
                   if sid in scoring_sids)]] if scoring_sids else []
    return {
        "streams": {str(sid): {"kernels": len(evs),
                               "device_ms": sum(e["dur"] for e in evs) / 1e3}
                    for sid, evs in per.items()},
        "scoring_streams": sorted(scoring_sids),
        "scoring_kernels": sum(any(k in e["name"] for k in SCORING_KERNELS)
                               for e in kernels),
        "overlap_ms": overlap / 1e3,
        "scoring_window_ms": _measure(window) / 1e3,
        "scoring_window_busy_ms": _intersect(every, window) / 1e3,
        "busy_ms": _measure(every) / 1e3,
        "span_ms": (every[-1][1] - every[0][0]) / 1e3 if every else 0.0}


def count_syncs(fn) -> dict:
    """Host syncs of one call of ``fn``, as torch's sync debug mode
    reports them (one warning per synchronizing call)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    msgs = [str(w.message) for w in caught
            if "synchroniz" in str(w.message)]
    return {"syncs": len(msgs), "first": msgs[:3]}


def phase_legs_pipelined() -> None:
    """One pipelined step (k = 1) against one serial es_step at the
    ``train`` path's shapes, in one call: whole-step ms (host clock to a
    device sync, median of 3, in the order pipelined, serial, serial,
    pipelined); one traced step of each with its kernels by CUDA stream
    (the scoring kernels must run on a stream the serial step does not
    use, which is the default stream the training leg runs on), the
    device time in which the two streams overlap; and the host syncs of
    one step of each under torch's sync debug mode, also for the drift
    cadence (one read of the servo a firing), serial and pipelined."""
    from repro_torch.core.engine import CadenceConfig, ESEngine
    tr = _trainer(PIPELINED_ARGS)
    eng, st = tr.engine, tr.state
    b0, b1 = (tr._place(tr.pipeline.batch_at(0, i)) for i in (0, 1))
    st = eng.prime_step(st, b0)
    pipe = lambda: eng.pipelined_step(st, (b0, b1))   # noqa: E731
    serial = lambda: eng.es_step(st, b0)              # noqa: E731
    order = (("pipelined", pipe), ("serial", serial), ("serial", serial),
             ("pipelined", pipe))
    ms = {"pipelined": [], "serial": []}
    for key, fn in order:
        ms[key].append(wall_ms(fn, 3))
    traces = {"pipelined": stream_trace(pipe), "serial": stream_trace(serial)}
    drift = ESEngine(tr.model_cfg, tr.es_cfg, tr.opt_cfg, tr.schedule,
                     cadence=CadenceConfig(kind="drift", k_cap=8),
                     store=tr.store)

    def fire(step_fn):
        # a due firing: the last one a period ago
        st.cadence.last_scored = st.opt.step - st.cadence.period
        step_fn()

    syncs = {"pipelined": count_syncs(pipe), "serial": count_syncs(serial),
             "drift_pipelined_firing": count_syncs(lambda: fire(
                 lambda: drift.pipelined_step(st, (b0, b1)))),
             "drift_serial_firing": count_syncs(lambda: fire(
                 lambda: drift.scheduled_step(st, b0)))}
    torch.cuda.reset_peak_memory_stats()
    pipe()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "legs_pipelined", "args": PIPELINED_ARGS,
          "whole_step_ms": ms, "traces": traces, "syncs": syncs,
          "pipelined_step_peak_memory": peak, "card": smi_line()})
    serial_streams = set(traces["serial"]["streams"])
    scoring = traces["pipelined"]["scoring_streams"]
    if len(scoring) != 1 or str(scoring[0]) in serial_streams \
            or len(traces["pipelined"]["streams"]) < 2:
        raise AssertionError(f"pipelined scoring kernels on streams "
                             f"{scoring}; the serial step ran on "
                             f"{sorted(serial_streams)}")
    if traces["pipelined"]["scoring_kernels"] != 27:
        raise AssertionError("pipelined trace: "
                             f"{traces['pipelined']['scoring_kernels']} "
                             "scoring kernels, expected 27 (24 flash, "
                             "2 xent, 1 score update)")
    if syncs["pipelined"]["syncs"] > syncs["serial"]["syncs"]:
        raise AssertionError(f"the pipelined step adds host syncs: {syncs}")
    del tr, eng, st, drift, b0, b1
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the training path's memory knobs, off against on
# ---------------------------------------------------------------------------

MEMORY_PATHS = ("train", "train_packed", "train_packed_m16", "train_long")


def _knob_trainer(args, knobs: str):
    """The path's trainer with the memory knobs as the config sets them
    ("on": qwen1.5-0.5b's selective remat, query chunks of 512, the
    trainer's cross-entropy chunks of 1,024), all three off ("off"), or
    the config's with remat "full"."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    if knobs == "off":
        tr = _trainer(args, dataclasses.replace(cfg, remat_policy="none",
                                                attn_chunk_q=0))
        tr.engine.es_cfg = tr.es_cfg = dataclasses.replace(tr.es_cfg,
                                                           seq_chunk=0)
        return tr
    if knobs == "full":
        return _trainer(args, dataclasses.replace(cfg, remat_policy="full"))
    return _trainer(args, cfg)


def train_leg(tr):
    """The trainer's training leg on its first meta-batch: forward and
    backward of the first b rows (serial ES), or the packed rows' one
    differentiated forward (packed ES)."""
    from repro_torch.core.engine import _value_and_grad
    from repro_torch.models.transformer import lm_per_segment_loss
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.pipeline.batch_at(0, 0))
    if tr.doc_level:
        return lambda: _value_and_grad(st.params, lambda: (
            lm_per_segment_loss(eng.model_cfg, st.params, batch,
                                seq_chunk=eng.es_cfg.seq_chunk)[0].mean(),
            None))
    sel = {k: v[:eng.es_cfg.minibatch] for k, v in batch.items()}
    return lambda: eng._loss_and_grads(st.params, sel)


def _knob_run(args, knobs: str) -> dict:
    """One trainer run of ``args`` with ``knobs``: its peak device memory,
    median step after the first and losses; then its training leg (and,
    serial ES, its scoring leg) on the first batch, median of 3."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _knob_trainer(args, knobs)
    out = tr.train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = [r["step_time"] * 1e3 for r in out["metrics"]]
    row = {"knobs": knobs, "remat_policy": tr.model_cfg.remat_policy,
           "attn_chunk_q": tr.model_cfg.attn_chunk_q,
           "seq_chunk": tr.es_cfg.seq_chunk, "max_memory_allocated": peak,
           "median_step_ms_after_first": statistics.median(steps[1:]),
           "step_ms": steps, "losses": [r["loss"] for r in out["metrics"]],
           "train_leg_ms": wall_ms(train_leg(tr), 3),
           "train_leg_device_ms": device_trace(train_leg(tr),
                                               reps=2)["device_ms"]}
    if not tr.doc_level:
        batch = tr._place(tr.pipeline.batch_at(0, 0))
        row["score_leg_ms"] = wall_ms(
            lambda: tr.engine._score_leg(tr.state, batch), 3)
    del tr
    torch.cuda.empty_cache()
    return row


def phase_memory() -> None:
    """The four paths whose training leg the knobs bound, each run with the
    knobs off and on in turns (off, on, on, off), in one call, and
    ``train`` also with remat "full". Each run's losses must be finite,
    and the knobs on must lower each path's peak. (Path A at meta-batch
    32, which fits only with the knobs on, is path ``train_packed_mb32``.)
    """
    rows = {}
    for name in MEMORY_PATHS:
        order = ("off", "on", "on", "off") + (("full",) if name == "train"
                                               else ())
        rows[name] = [_knob_run(PATH_ARGS[name], k) for k in order]
    emit({"phase": "memory", "rows": rows, "card": smi_line()})
    for name, runs in rows.items():
        for r in runs:
            if not all(map(math.isfinite, r["losses"])):
                raise AssertionError(f"memory {name} {r['knobs']}: "
                                     f"non-finite losses {r['losses']}")
        off = [r["max_memory_allocated"] for r in runs if r["knobs"] == "off"]
        on = [r["max_memory_allocated"] for r in runs if r["knobs"] == "on"]
        if max(on) >= min(off):
            raise AssertionError(f"memory {name}: knobs on peak {on}, off "
                                 f"{off}")


# ---------------------------------------------------------------------------
# phase 11: set-level pruning's host cost at a user's dataset sizes
# ---------------------------------------------------------------------------

PRUNE_SIZES = (1 << 20, 1 << 24)
PRUNE_METHODS = ("eswp", "infobatch", "ucb", "ka", "random")
# ids a store update takes in the fill: the int8 grow kernel scans its
# batch once per position, so its batches stay at one kernel chunk
FILL_BATCH = {"f32": 1 << 20, "int8": 4096}


def fill_store(kind: str, n: int, g: torch.Generator):
    """A store of n rows on the card (f32, or int8 in blocks of 1,024 with
    a ring of 1,024), every row scored once in random order through the
    store's update kernel(s), then a random quarter of the rows again
    (so ``seen`` is 1 or 2) -> (store, scores, fill seconds)."""
    from repro_torch.core.scores import make_store
    store = make_store(None, quantize=kind == "int8", block=1024,
                       residual_rows=1024)
    scores = store.init_leaf(n, "cuda")
    ids = torch.cat([torch.randperm(n, generator=g, device="cuda"),
                     torch.randperm(n, generator=g, device="cuda")[:n // 4]]
                    ).to(torch.int32)
    losses = torch.rand(ids.shape[0], generator=g, device="cuda") * 8 + 0.1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    B = FILL_BATCH[kind]
    for lo in range(0, ids.shape[0], B):
        store.update(scores, ids[lo:lo + B], losses[lo:lo + B], 0.2, 0.9)
    torch.cuda.synchronize()
    return store, scores, time.perf_counter() - t0


def plain_snapshot(kind: str, scores) -> tuple:
    """(weights, losses, seen) of the store as numpy arrays, from the
    store's tensors copied plainly; an int8 store's values dequantised on
    the card (code * its block's scale, then each live ring row's
    residual; the ring's rows are distinct after the fill)."""
    torch.cuda.synchronize()
    if kind == "f32":
        return tuple(t.cpu().numpy() for t in (scores.w, scores.s,
                                               scores.seen))
    live = scores.err_seq > 0
    rows = scores.err_rows[live].long()
    if rows.unique().numel() != rows.numel():
        raise AssertionError("prune: ring rows repeat after the fill")

    def deq(q, scale, err):
        v = q.float() * torch.repeat_interleave(scale, 1024)[:q.shape[0]]
        v[rows] = v[rows] + err[live]
        return v.cpu().numpy()

    return (deq(scores.w_q, scores.w_scale, scores.err_w),
            deq(scores.s_q, scores.s_scale, scores.err_s),
            scores.seen_q.to(torch.int32).cpu().numpy())


def phase_prune() -> None:
    """Set-level pruning at n = 2^20 and 2^24 rows, over the f32 and the
    int8 store filled through their kernels: the snapshot (the device
    sync and copy to the host, and the int8 dequant; median of 3) held
    bitwise against the store's tensors copied plainly, then each method's
    decision on it (host clock, one call) held against ``prune_epoch`` on
    those plain arrays with the same generator (kept-set and grad scales
    bitwise). KA's previous losses are the snapshot's, each scaled by a
    factor in [0.9, 1.1]."""
    import numpy as np
    from repro_torch.core.pruning import prune_epoch, prune_epoch_snapshot
    rows = []
    for n in PRUNE_SIZES:
        for kind in ("f32", "int8"):
            g = _gen(11)
            store, scores, fill_s = fill_store(kind, n, g)
            snap_ms = [wall_ms(lambda: store.prune_snapshot(scores), 1,
                               warmup=0) for _ in range(3)]
            snap = store.prune_snapshot(scores)
            w, s, seen = plain_snapshot(kind, scores)
            for name, got, want in (("weights", snap.weights[0], w),
                                    ("losses", snap.losses[0], s),
                                    ("seen", snap.seen[0], seen)):
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(f"prune {kind} n={n}: snapshot "
                                         f"{name} differs")
            prev = (s * np.random.default_rng(5).uniform(
                0.9, 1.1, n)).astype(np.float32)
            decide_ms, kept = {}, {}
            for i, m in enumerate(PRUNE_METHODS):
                t0 = time.perf_counter()
                res = prune_epoch_snapshot(m, np.random.default_rng((n, i)),
                                           snap, prev_losses=prev,
                                           ratio=0.2)
                decide_ms[m] = (time.perf_counter() - t0) * 1e3
                want = prune_epoch(m, np.random.default_rng((n, i)),
                                   weights=w, losses=s, seen=seen,
                                   prev_losses=prev, ratio=0.2)
                same = np.array_equal(res.kept, want.kept) and (
                    (res.grad_scale is None and want.grad_scale is None)
                    or np.array_equal(res.grad_scale, want.grad_scale))
                if not same:
                    raise AssertionError(f"prune {kind} n={n}: {m} kept-set "
                                         f"differs from prune_epoch's")
                kept[m] = int(len(res.kept))
            if kept["eswp"] != round(0.8 * n):
                raise AssertionError(f"prune {kind} n={n}: eswp kept "
                                     f"{kept['eswp']}")
            rows.append({"n": n, "store": kind, "fill_s": fill_s,
                         "snapshot_ms": snap_ms, "decide_ms": decide_ms,
                         "kept": kept})
            emit({"phase": "prune", **rows[-1], "card": smi_line()})
            del store, scores, snap
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: checkpoint and resume, bitwise, in a deterministic subprocess
# ---------------------------------------------------------------------------

# path -> the step its interrupted run stops at: 2 of 4, or mid-epoch 1 of
# train_eswp (8 of 12 steps), after its second prune decision; train_grown
# at the end of epoch 0, after its grow
RESUME_PATHS = {"train": 2, "train_pipelined": 2, "train_quant": 2,
                "train_eswp": 8, "train_grown": 2, "train_gc": 2}
# S1 over 64 samples in a StreamingSource: a step hook appends 32 rows and
# grows at step 1, so epoch 1 walks 96 rows (3 steps); 4 steps in all
GROWN_ARGS = TRAIN_ARGS + ["--n-samples", "64", "--epochs", "2",
                           "--max-steps", "4"]


def _grown_trainer(args, model_cfg=None, **tc_fields):
    """The trainer of ``args`` over a StreamingSource, with a step hook
    that appends 32 fixed rows and grows at step 1 (in epoch 0)."""
    from repro_torch.data.pipeline import StreamingSource, get_source
    from repro_torch.launch import train
    from repro_torch.launch.service import _synthetic_stream
    ns = train.build_parser().parse_args(args)
    fields = set(train.TrainerConfig.__dataclass_fields__)
    tc = train.TrainerConfig(**{**{k: v for k, v in vars(ns).items()
                                    if k in fields}, **tc_fields})
    tr = train.Trainer(tc, model_cfg=model_cfg, source=StreamingSource(
        get_source("synthetic", n_samples=tc.n_samples, seq_len=tc.seq_len,
                   vocab_size=64, seed=tc.seed)))
    tok, lab = _synthetic_stream(tc.seq_len, 64, seed=2, n=32)

    def grow_at_step_1(t, epoch):
        if t.global_step == 1:
            t.grow(len(t.source.append(tok, lab)), epoch)
    tr.step_hooks.append(grow_at_step_1)
    return tr


RESUME_ARGS = {**PATH_ARGS, "train_grown": GROWN_ARGS, "train_gc": GC_ARGS}
# the script's time: a resume is bitwise or not whatever the depth, so
# every path but ``train`` (the checkpoint cost at full depth) resumes
# qwen1.5-0.5b at its published widths cut to 4 of its 24 layers; the
# write of its 5.57 GB checkpoint took most of the phase's 214 s
RESUME_LAYERS = 4
RESUME_BUILD = {"train_grown": _grown_trainer}


def _differing(got: dict, want: dict) -> list:
    """Paths of the leaves of two ``ESEngine.state_dict`` trees that are
    missing from one or not bitwise equal."""
    from repro_torch.checkpoint.checkpointer import flatten
    g, w = flatten(got), flatten(want)
    return sorted(set(g) ^ set(w)) + [
        k for k in w if k in g and not (g[k].dtype == w[k].dtype
                                        and torch.equal(g[k], w[k]))]


def _prune_state(tr) -> dict:
    """What set-level pruning carries across a resume: the kept-set's
    digest and the last prune's s snapshot (``prev_epoch_losses``)."""
    prev = tr.prev_epoch_losses
    return {"kept_digest": tr.pipeline.cursor(0, 0)["kept_digest"],
            "prev_epoch_losses": None if prev is None else prev.tobytes()}


def _resume_path(name: str, ckpt_dir: Path) -> dict:
    """``name`` run straight, against a run stopped at
    ``RESUME_PATHS[name]`` with ``--ckpt-dir`` and a resumed run to the
    same end: the tail's losses, the final state (every leaf of
    ``ESEngine.state_dict``), the kept-set's digest and
    ``prev_epoch_losses`` must be bitwise equal. The interrupted run of
    ``train`` also saves asynchronously at step 2 (then the final save
    overwrites that step)."""
    import dataclasses

    from repro_torch.configs import get_config
    args, stop = RESUME_ARGS[name], RESUME_PATHS[name]
    cfg = None if name == "train" else dataclasses.replace(
        get_config("qwen1.5-0.5b"), num_layers=RESUME_LAYERS)
    build = partial(RESUME_BUILD.get(name, _trainer), model_cfg=cfg)
    ref = build(args)
    ref_out = ref.train()
    want = ref.engine.state_dict(ref.state)
    want_prune = _prune_state(ref)
    want_rows = (ref.n_train, len(ref.source), ref.pipeline.cursor(0, 0))
    tail = [r["loss"] for r in ref_out["metrics"][stop:]]
    del ref
    first = build(args + ["--max-steps", str(stop), "--ckpt-dir",
                          str(ckpt_dir)],
                  ckpt_every_steps=2 if name == "train" else 50)
    first.ckpt.keep = 1
    first.train()
    saves = first.ckpt.timings
    del first
    torch.cuda.empty_cache()
    res = build(args + ["--ckpt-dir", str(ckpt_dir)])
    res.ckpt.keep = 1
    restored_at = res.global_step
    restored_rows = res.n_train
    out = res.train()
    torch.cuda.synchronize()
    got = res.engine.state_dict(res.state)
    losses = [r["loss"] for r in out["metrics"]]
    differ = _differing(got, want)
    same_prune = _prune_state(res) == want_prune
    same_rows = (res.n_train, len(res.source),
                 res.pipeline.cursor(0, 0)) == want_rows
    nbytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                 if f.is_file())
    row = {"restored_at": restored_at, "held": res._resume_held,
           "tail_losses": tail, "resumed_losses": losses,
           "differing_leaves": differ, "saves": saves,
           "kept_digest": want_prune["kept_digest"],
           "prune_state_equal": same_prune, "restored_rows": restored_rows,
           "rows": want_rows[:2], "rows_equal": same_rows,
           "restore_s": [t["seconds"] for t in res.ckpt.timings
                         if t["op"] == "restore"],
           "bytes_on_disk": nbytes}
    del res, got, want
    torch.cuda.empty_cache()
    if restored_at != stop or losses != tail or differ or not same_prune \
            or not same_rows or restored_rows != want_rows[0]:
        raise AssertionError(f"resume {name}: {row}")
    return row


def resume_phase() -> None:
    """``--resume-phase`` (the child process of phase ``resume``): the
    paths' kill and resume under deterministic algorithms, in a temporary
    directory removed afterwards."""
    import shutil
    import tempfile
    torch.use_deterministic_algorithms(True)
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        for name in RESUME_PATHS:
            rows[name] = _resume_path(name, Path(d) / name)
            shutil.rmtree(Path(d) / name)
    emit({"phase": "resume", "deterministic":
          torch.are_deterministic_algorithms_enabled(),
          "cublas_workspace_config": os.environ.get(
              "CUBLAS_WORKSPACE_CONFIG"),
          "disk_free_bytes": free, "paths": rows, "card": smi_line()})


def phase_resume() -> None:
    """Run ``resume_phase`` in a child process with deterministic
    algorithms and a fixed cuBLAS workspace: the embedding's backward
    accumulates with atomics unless torch is asked for its deterministic
    form, and cuBLAS on two streams needs fixed workspaces to repeat its
    sums. The child inherits stdout; its failure fails this run."""
    sys.stdout.flush()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--resume-phase"], env=env, check=True)


def store_bench(src: str) -> None:
    """``--store-bench SRC``: only ``store_timings``, on the port found
    under SRC (another tree's ``src``, e.g. a parent commit unpacked with
    ``git archive``), which builds its own kernels from its own sources."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    phase_device()
    emit({"phase": "store_bench", "src": src,
          "port": str(Path(repro_torch.__file__).parent),
          "timings": store_timings(), "card": smi_line()})


def segsum_bench(src: str) -> None:
    """``--segsum-bench SRC``: only ``segsum_tree_timings`` and the trace
    of path A's forward + backward, on the port found under SRC, which
    builds its own kernels from its own sources; a slot count its kernel
    refuses is reported as "refused"."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    phase_device()
    timings = segsum_tree_timings(refusable=True)
    _, _, fwd_bwd = packed_forward_backward()
    fwd_bwd()
    emit({"phase": "segsum_bench", "src": src,
          "port": str(Path(repro_torch.__file__).parent), "timings": timings,
          "forward_backward_trace": forward_backward_trace(fwd_bwd),
          "card": smi_line()})


BENCHES = {"--store-bench": store_bench, "--segsum-bench": segsum_bench}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] in BENCHES:
        BENCHES[sys.argv[1]](sys.argv[2])
        return
    if sys.argv[1:] == ["--resume-phase"]:
        resume_phase()
        return
    if len(sys.argv) > 1:
        sys.exit("usage: chip_smoke.py [--store-bench SRC | --segsum-bench "
                 "SRC]")
    seconds = {}

    def timed(name, fn):
        """Run a phase, keeping its wall seconds (the script's budget)."""
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    phase_device()
    errs = timed("check", phase_check)
    times = timed("time", phase_time)
    timed("model", phase_model)
    launches = {}
    runs = {**{p: lambda p=p: phase_path(p) for p in PATH_ARGS},
            "train_tokens": phase_train_tokens, "serve": phase_serve,
            "service": phase_service,
            **{p: lambda p=p: phase_family(p) for p in FAMILY_ARGS},
            "serve_mamba2": phase_serve_mamba2,
            "serve_moe": phase_serve_moe}
    for name, run in runs.items():
        for k, v in timed(name, run).items():
            launches[k] = launches.get(k, 0) + v
    for name, fn in (("legs", phase_legs), ("legs_packed", phase_legs_packed),
                     ("data", phase_data),
                     ("legs_pipelined", phase_legs_pipelined),
                     ("memory", phase_memory), ("prune", phase_prune),
                     ("resume", phase_resume)):
        timed(name, fn)
    emit({"phase": "seconds", "seconds": seconds,
          "total": round(sum(seconds.values()), 1)})
    kernels = []
    for name, meta in KERNELS.items():
        t = times[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} launched on no main path")
        kernels.append({
            "name": name, **meta, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t.get("device_ms"),
            "library_device_ms": t.get("library_device_ms")})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
