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
   families' (M, V, d) and flash shapes, head dim 80 included, seamless's
   vocab of 256,256 and llama-3.2-vision's d of 4,096, seamless's encoder
   without the causal mask and llama-3.2-vision's GQA 32:8); the f32 score
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
   bitwise (no atomics); and the xent partials over a vocabulary split
   in two (labels outside a slice, below 0 and in its last tile's
   padding, add exactly 0), folded by the combine kernel;
4. ``time`` each kernel, its plain version and one PyTorch library call
   with CUDA events, the kernels alone under torch.profiler (device ms;
   the library call's too), compute each kernel's bound from its inputs,
   an empty kernel's device time (the floor of any launch), xent and
   flash also at the other families' shapes (zamba2, grok-1, seamless,
   llama-3.2-vision), and the two
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
   then the store in four row blocks on the card (phase 6e):
   ``train_sharded`` (S1 with ``--shard-scores``) and
   ``train_sharded_quant`` (``train_quant`` with ``--shard-scores
   --quant-wire``), 4 steps each, the engine's store calls recorded and
   replayed after the path into a replicated store (bitwise; the int8
   wire's gathers within one grid step and its selections within one
   key-grid step), four launches of each store kernel a step, and one
   step's store work timed per layout;
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
   (mamba2-780m at its published widths, 16 of 48 layers, S1's traffic:
   one xent call and one store update a step, no flash), ``train_zamba2``
   (zamba2-2.7b at its published widths, 3 of 9 sites, meta-batch 16,
   minibatch 4: three flash launches at head dim 80 a scoring leg),
   ``train_moe`` (arctic's smoke config: 8 experts top-2 and a dense
   residual) and ``train_gc`` (S1 with ``--grad-compression``), 4 steps
   each; each family path holds its first scoring leg's per-sample losses
   to the plain forward (``scoring=False``, no grad) on the same batch
   and weights within 5e-2 and reports its scoring and training legs
   (host clock and device time); ``train_gc`` reports the compression
   leg and the residuals' bytes and holds ``compress_decompress`` on the
   card to a CPU copy bitwise; ``serve_mamba2`` (full-width mamba2, 16
   of 48 layers, no kernel launch at all) and ``serve_moe`` (grok-1 at its published
   widths cut to 2 layers, 16 tokens; the checks at a dropless capacity)
   as ``serve``; then the vlm and encdec families (phase 6d), which the
   trainer refuses (no source makes their frontend stubs):
   ``train_encdec`` (seamless-m4t-large-v2 at its published widths, 12
   + 12 of 24 + 24 layers) and ``train_vlm`` (llama-3.2-vision-11b at its published widths,
   depth cut 40 -> 5: one site, its gates drawn non-zero), each 4 serial
   ES steps through ``ESEngine.scheduled_step`` at S1's traffic on
   batches that carry frames (32, 128, 1,024) or image embeddings (32,
   1,600, 4,096) drawn on the card in bf16 (launches a step: flash 24 or
   5, xent 1, score update 1; the first scoring leg against the plain
   forward; legs, peak, step times); ``serve_vlm`` (llama-3.2-vision-11b at
   its published widths, 10 of 40 layers, gates non-zero, 16 tokens: 10
   flash launches a prefill) and ``serve_encdec`` (seamless, 16 tokens: 24,
   the encoder's 12 without the causal mask) as ``serve``, on the server's
   stubs. Every ``serve*`` path with attention also runs a third prefill
   with its attention through SDPA in bf16: the kernel prefill's logits are
   held within 5e-2 of the plain prefill's, or, past it, within 1.25 times
   the SDPA prefill's gap (``SDPA_SLACK``); then phase ``dryrun``:
   the dry run (``repro_torch.launch.dryrun``) predicts each of its cells
   on the ``meta`` device, and the card runs the same step (a warm-up
   step, then one under the same cost counter, with the launch counts
   set to 0 just before and read just after, then the profiler's device
   time of one more): D1, full-width qwen1.5-0.5b's ``es_step`` at S1's
   traffic (S 512, meta-batch 32, minibatch 8: 24 flash launches, one
   xent call, one score update); D2, SV's prefill (batch 8, prompts of
   512: 24 flash) and one decode step on its cache of 576; D3,
   mamba2-780m x ``long_500k`` (one decode step, batch 1, cache 524,288)
   and zamba2-2.7b's when the dry run says it fits one card, all at full
   width and depth. Each fails unless the card's FLOP count equals the
   meta count exactly, the measured peak (``max_memory_allocated`` after
   ``reset_peak_memory_stats``) is within 5 % or 256 MiB of the
   predicted one, whichever is larger, the roofline share (the
   predicted ``step_s_lower_bound`` over the device time) is at most
   1.05, and the step's losses or logits are finite; then phase
   ``mesh``: the dense model sharded over a (2, 2) ("data", "model")
   mesh of four child processes (``--mesh-child RANK PORT DIR``, a gloo
   group over rank 0's ``TCPStore``) on the one card, their collectives
   staged through pinned host buffers: full-width qwen1.5-0.5b's
   ``es_step`` at S1's traffic under ``fsdp_on`` (data, FSDP and tensor
   legs), then SV's prefill and four decode steps under
   ``kv_replicate`` (the cache's sequence over "model"), on the shards
   of this process's weights and rows of its batch; each rank held to
   this process's one-process run (the same selected rows, scoring
   losses within 5e-2, first and second moments within 5e-2 and 1e-1
   in L2, the updated weights AdamW's step by them within 1e-6; the
   prefill's and each decode step's logits within 5e-2 x max(1,
   |logit|) of the plain run's, or 1.25 x the largest gap of an
   SDPA-bf16 run of the same steps; the prefill and decode steps again
   in float32 compute within 1e-4 x max(1, |logit|) of the one-process
   float32 run) and each measured call
   (the ES step, the prefill, the first decode step) to the dry run's
   trace of the same (2, 2) cell under a fake group of 4 (FLOPs equal,
   peak within 5 % or 256 MiB, collective bytes equal, launches: flash
   24 a scoring forward and a prefill on 8 local heads, xent's two
   halves on the rank's vocabulary slice, one score update); then
   ``mesh_moe`` (grok-1 and arctic, one layer each) and ``mesh_ssm``
   (mamba2-780m, 2 layers, and zamba2-2.7b, one site, at published
   widths, FSDP on: the ES step, SV's prefill and four decode steps in
   bf16 and float32, the replicated Mamba2 leaves over "model", and the
   ES state checkpointed from the four ranks and restored onto them and
   onto one process, bitwise) on the same four processes;
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
   ``train_long``, 2 steps each, with the memory knobs off, then on (peak
   device memory, the training leg's time and device time, the scoring
   leg, the median step) and ``train`` with remat "full";
11. ``prune``: the f32 and the int8 store at n = 2^20 and 2^24 rows,
   filled through their update kernels; the snapshot's time (device sync
   and copy to the host) held bitwise against the store's tensors copied
   plainly, and each set-level method's decision time on it, its kept-set
   held against ``prune_epoch`` on those arrays; then ``cluster``: two
   child processes (``--cluster-child RANK PORT DIR``, a gloo group over
   a ``TCPStore`` on a free localhost port) share the card, each owning
   2^23 of 2^24 rows in two blocks, through the multi-host workload
   (gathers, updates, a selection, the five prune methods, the int8
   store with a grow, a partitioned checkpoint), bitwise this process's
   one-process run, the checkpoint restored here onto a replicated and a
   four-block store; the host legs' times and the store bytes;
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
   to 4: the same, and the grown store, source and cursor restored; and
   ``train_preempt`` (S1 at 4 of 24 layers): SIGTERM from a step hook
   after step 2, so the trainer finishes step 3, writes its final
   checkpoint and stops, then resumed to 4.
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

import atexit
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
from typing import Optional

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
    "train_zamba2": {"fused_xent": 1, "gqa_flash_attention": 3,
                     "fused_score_update": 1},
    "train_moe": {"fused_xent": 1, "gqa_flash_attention": 2,
                  "fused_score_update": 1},
    "train_gc": SCORING_LEG,
    # the store in four row blocks (phase 6e): each block's kernels launch
    # once a scoring leg
    "train_sharded": {"fused_xent": 1, "gqa_flash_attention": 24,
                      "fused_score_update": 4},
    "train_sharded_quant": {"fused_xent": 1, "gqa_flash_attention": 24,
                            "quant_grow_scales": 4, "quant_ring_slots": 4,
                            "fused_quant_score_update": 4},
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


def check_xent_split(M: int, V: int, d: int, m: int) -> float:
    """The vocabulary split over m ranks (phase ``mesh``'s scoring
    cross-entropy): the partials kernel on each slice of V / m rows with
    the labels shifted by the slice's offset, so that each slice sees
    labels below 0 and at or past its end, the padded columns of its last
    ragged tile included (a third of the rows' labels are put there). A
    label outside the slice must add exactly 0 to the target partial; the
    partials against the plain version's; the slices' partials, folded
    rank-major by the combine kernel, against the whole table's plain
    cross-entropy."""
    from repro_torch.kernels.xent.ops import plan_span, xent_combine, \
        xent_partials
    from repro_torch.kernels.xent.ref import xent_partials_ref, xent_ref
    h, w, labels = xent_inputs(M, V, d, seed=2)
    n = V // m
    labels[::3] = n + labels[::3] % 64       # past slice 0's last column
    parts, errs = [], []
    for r in range(m):
        local = (labels - r * n).contiguous()
        span = plan_span(h, n)
        got = xent_partials(h, w[r * n:(r + 1) * n].contiguous(), local,
                            span)
        want = xent_partials_ref(h, w[r * n:(r + 1) * n], local, span)
        outside = (local < 0) | (local >= n)
        if not bool(outside.any()) or \
                bool((got[outside][..., 2] != 0).any()):
            raise AssertionError(f"xent split {r}/{m}: a label outside the "
                                 f"slice reached the target partial")
        errs += [(got[..., 0] - want[..., 0]).abs().max().item(),
                 (got[..., 1] / want[..., 1] - 1).abs().max().item(),
                 (got[..., 2] - want[..., 2]).abs().max().item()]
        parts.append(got)
    nll = xent_combine(torch.cat(parts, dim=1).contiguous())
    errs.append((nll - xent_ref(h, w, labels)).abs().max().item())
    torch.cuda.synchronize()
    if not max(errs) <= XENT_TOL:
        raise AssertionError(f"xent split M={M} V={V} d={d} over {m}: "
                             f"|err| {errs} > {XENT_TOL}")
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
                          check_xent_split(8192, 151936, 1024, 2),
                          # the other families' scoring forwards (mamba2,
                          # zamba2, the arctic smoke path) and grok-1's
                          # (d, V), which no training path reaches
                          check_xent(16384, 50304, 1536),
                          check_xent(8192, 32000, 2560),
                          check_xent(16384, 128, 64),
                          check_xent(2048, 131072, 6144),
                          # the vlm's and the encdec's scoring legs:
                          # seamless's vocab (1,001 vocab tiles) and
                          # llama-3.2-vision's d (64 k slices a tile)
                          check_xent(16384, 256256, 1024),
                          check_xent(16384, 128256, 4096)),
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
            check_flash(2, 512, 56, 8, 128, True),
            # seamless's encoder (no causal mask, 128 frames) and
            # llama-3.2-vision's self-attention (GQA 32:8, head dim 128)
            # at the engine paths' and the prefill's shapes
            check_flash(32, 128, 16, 16, 64, False),
            check_flash(32, 512, 32, 8, 128, True),
            check_flash(8, 512, 32, 8, 128, True)),
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
    out = {}

    out["fused_xent"] = time_xent(32 * 512, 151936, 1024)
    # the encdec's and the vlm's scoring legs (seamless's vocab,
    # llama-3.2-vision's d)
    out["fused_xent"]["at"] = {
        "seamless_v256256": time_xent(32 * 512, 256256, 1024),
        "llama32v_d4096": time_xent(32 * 512, 128256, 4096)}

    out["gqa_flash_attention"] = time_flash(32, 512, 16, 16, 64)
    # zamba2-2.7b's shared block (head dim 80) at train_zamba2's scoring
    # shape, grok-1's prefill (GQA 48:8, head dim 128) at serve_moe's,
    # seamless's encoder (no causal mask) at train_encdec's and
    # llama-3.2-vision's self-attention at serve_vlm's prefill
    out["gqa_flash_attention"]["at"] = {
        "zamba2_hd80": time_flash(16, 512, 32, 32, 80),
        "grok1_prefill_hd128": time_flash(8, 512, 48, 8, 128),
        "seamless_encoder_noncausal": time_flash(32, 128, 16, 16, 64,
                                                 causal=False),
        "llama32v_prefill_hd128": time_flash(8, 512, 32, 8, 128)}

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


def time_xent(M: int, V: int, d: int) -> dict:
    """The xent wrapper (two kernels) at one shape: events and device ms,
    its plain version, the library form (the logits, logsumexp, gather),
    and the bound (2 M V d flops; h, W and labels read, the NLL
    written)."""
    from repro_torch.kernels.xent.ops import fused_xent
    from repro_torch.kernels.xent.ref import xent_ref
    h, w, labels = xent_inputs(M, V, d)

    def xent_library():
        logits = h @ w.t()
        return (torch.logsumexp(logits.float(), -1)
                - logits.gather(1, labels.long()[:, None])[:, 0].float())

    flops, nbytes = 2.0 * M * V * d, 2 * M * d + 2 * V * d + 4 * M + 4 * M
    bms, by = bound(flops, nbytes)
    row = {
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
    return row


def time_flash(B: int, S: int, H: int, K: int, hd: int,
               causal: bool = True) -> dict:
    """The flash kernel at one shape: events and device ms, its plain
    version, SDPA (events and device), and the bound of the shape (q, k,
    v read and o written once; 4 hd flops a (query, key) pair: the causal
    half, or all of them)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    q, k, v = flash_inputs(B, S, H, K, hd)
    # SDPA takes (B, heads, S, hd) and repeats the kv heads itself
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if H != K else {}
    pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
    flops = 4.0 * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    bms, by = bound(flops, nbytes)

    def kernel():
        return gqa_flash_attention(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              **gqa)
    row = {"ms": time_ms(kernel, 20),
           "device_ms": kernel_device_ms(kernel, "flash_fwd_kernel"),
           "plain_ms": time_ms(lambda: flash_attention_ref(
               q, k, v, causal=causal), 5),
           "library_ms": time_ms(library, 20),
           "library_device_ms": device_trace(library)["device_ms"],
           "bound_ms": bms, "bound_by": by,
           "shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd,
                     "causal": causal}}
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


def phase_path(name: str, args=None, watch=None, model_cfg=None) -> dict:
    """Run one path through the trainer the CLI builds (``Trainer.train``)
    with every launch count set to 0 just before and read just after.
    ``args`` replaces the path's own, ``model_cfg`` the model its
    ``--arch`` names; ``watch(tr)``, called on the built trainer, returns
    a check called as ``check(tr, out)`` after the run."""
    args = args or PATH_ARGS[name]
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _trainer(args, model_cfg)
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
def sdpa_attention():
    """The prefill's attention through one PyTorch library call,
    ``scaled_dot_product_attention`` in bf16 (GQA, causal or not): a
    second bf16 prefill, the measure of how far two correct bf16
    attentions put a model's logits from the plain prefill."""
    import torch.nn.functional as F
    from repro_torch.models import attention
    kernel = attention.gqa_flash_attention

    def sdpa(q, k, v, causal=True):
        gqa = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, **gqa)
        return out.transpose(1, 2)
    attention.gqa_flash_attention = sdpa
    try:
        yield
    finally:
        attention.gqa_flash_attention = kernel


@contextlib.contextmanager
def flash_inputs_of(record: list):
    """Keep the (q, k, v, causal) of every flash-kernel call made
    inside."""
    from repro_torch.models import attention
    kernel = attention.gqa_flash_attention

    def spy(q, k, v, causal=True):
        record.append((q, k, v, causal))
        return kernel(q, k, v, causal=causal)
    attention.gqa_flash_attention = spy
    try:
        yield
    finally:
        attention.gqa_flash_attention = kernel


class Routed(Exception):
    """Raised after a MoE call's routing (``dispatch_spy(stop=True)``)."""


@contextlib.contextmanager
def dispatch_spy(record: list, replay=None, coord: int = 0,
                 stop: bool = False):
    """Each MoE call's (expert ids, kept pairs, flips), in call order, into
    ``record`` (on the host). ``replay``: another run's record, whose
    expert ids this run routes with, one entry a call: a rank takes its
    own groups of it (the ``coord``-th G / dp of them; a group it shares
    is taken whole); ``flips`` counts the tokens whose own top k differ
    (a bf16 near-tie of two router logits). ``stop``: raise ``Routed``
    after the first routing (the float32 reruns that cannot hold a
    float32 copy of their expert stacks check the routes alone)."""
    from repro_torch.models import moe
    inner_route, inner_top_k = moe.route, moe._top_k
    pending = iter(replay) if replay is not None else None

    def route(logits, k, C):
        flips = 0
        if pending is not None:
            idx = _own_groups(next(pending)[0], logits.shape[0], coord).to(
                logits.device)
            flips = int((inner_top_k(logits, k)[1] != idx).any(-1).sum())
            moe._top_k = lambda l, kk: (l.gather(-1, idx), idx)
        try:
            out = inner_route(logits, k, C)
        finally:
            moe._top_k = inner_top_k
        record.append((out[1].cpu(), out[3].cpu(), flips))
        if stop:
            raise Routed()
        return out
    moe.route = route
    try:
        yield
    finally:
        moe.route = inner_route


def _own_groups(t: torch.Tensor, n: int, coord: int) -> torch.Tensor:
    """A one-process record's (G, ...) entry cut to a rank's ``n`` groups:
    the ``coord``-th n of them, or all of them when the rank routes every
    group (a group spanning its data ranks)."""
    return t if t.shape[0] == n else t[coord * n:(coord + 1) * n]


def _expect(what: str, got: dict, want: dict) -> None:
    """Every wrapper's launches in ``got`` as ``want`` says (absent: 0)."""
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {bad}, expected {want}")


# the prefill check (decided before the vlm and encdec paths first ran):
# the kernel prefill's logits within MODEL_TOL of the plain prefill's; a
# model whose bf16 sensitivity puts them past it (grok's widths, 40 layers
# of d 4,096) is held instead to SDPA_SLACK times the gap of a second
# bf16 prefill through SDPA (``sdpa_attention``), with the kernel within
# its own tolerance on every layer's q, k, v
SDPA_SLACK = 1.25


def phase_serve(name: str = "serve", cfg=None, gen: int = SERVE_GEN,
                expect=None, check_cfg=None, exact=False,
                gates: bool = False) -> dict:
    """``Server.generate`` on ``cfg`` (full-width qwen1.5-0.5b by default):
    batch 8, prompts of 512 tokens, ``gen`` greedy tokens, on the
    server's frontend stubs for vlm and encdec (drawn once and given to
    every call; ``gates``: the vlm's gates drawn non-zero). The whole
    ``generate`` launches ``expect`` (by default the flash kernel once a
    self-attention layer, encoder included, in the prefill) and nothing
    else. Its prefill's logits are held to the plain prefill's on the
    card (``SDPA_SLACK`` above), and a few teacher-forced decode steps to
    the full (training-path) forward over the same prefix, both on
    ``check_cfg`` (``cfg`` by default; a MoE is held with a dropless
    capacity, where one-token decode routes as the full forward does; the
    plain and SDPA prefills take the kernel's routes, ``dispatch_spy``).
    With ``exact`` the teacher-forced steps are held in float32 compute,
    over a float32 cache that the plain prefill fills (the flash kernel
    takes bf16 only), as ``tests/test_decode.py`` holds the reference: in
    bf16 an SSM's forward and decode round at other places (bf16 conv
    weights and activations against float32 ones) and a MoE's routing
    flips at near-ties, so their bf16 gaps are reported, not held;
    ``exact="auto"`` holds them in bf16 where they meet MODEL_TOL and in
    float32 otherwise, the bf16 gap reported. The flash kernel is also
    held to its plain version on the very (q, k, v) of each of the
    prefill's attention layers. Times: the prefill alone, the whole
    ``generate`` (host clock to a device sync), the decode's ms a token
    from the two, tokens/s, peak memory, and the device time and launches
    of one prefill and of one decode step (torch.profiler)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import unembed_matrix
    from repro_torch.models.losses import last_token_logits
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.transformer import (lm_hidden, memory_of,
                                                tree_leaves)
    cfg = cfg or get_config("qwen1.5-0.5b")
    ccfg = check_cfg or cfg
    expect = {"gqa_flash_attention": cfg.num_layers
              + cfg.num_encoder_layers} if expect is None else expect
    B, P, G = SERVE_B, SERVE_P, gen
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = Server(cfg, device="cuda", seed=0)
    params = server.params
    if gates:
        set_gates(params, seed=9)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=_gen(7),
                            device="cuda", dtype=torch.int32).cpu().numpy()
    aux = server.stub_inputs(B, P, _gen(8))
    for fn in wrappers.values():
        fn.launches = 0
    out = server.generate(prompts, G, aux=aux)
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
            return prefill(c, params, {"tokens": tokens, **aux},
                           init_cache(c, B, P + G, device="cuda"))

    prefill_ms = wall_ms(run_prefill, 5)
    gen_ms = wall_ms(lambda: server.generate(prompts, G, aux=aux), 3)
    prefill_trace = device_trace(run_prefill, 5)
    seq = torch.as_tensor(out, device="cuda")

    def teacher_forced(c, cache):
        """TEACHER_STEPS decode steps of ``c`` over ``cache`` against the
        full forward over the same prefix."""
        errs = []
        for t in range(TEACHER_STEPS):
            logits, cache = decode_step(c, params, seq[:, P + t:P + t + 1],
                                        cache, P + t)
            h = lm_hidden(c, params, seq[:, :P + t + 1],
                          memory=memory_of(c, aux))
            full = last_token_logits(h[:, -1:],
                                     unembed_matrix(params["embed"]))
            errs.append(logit_errs(logits, full))
            del h, full
        return errs

    with torch.no_grad():
        fast_routes, free_routes, qkv = [], [], []
        with dispatch_spy(fast_routes), flash_inputs_of(qkv):
            fast, cache = run_prefill(ccfg)
        from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
        from repro_torch.kernels.flash_attn.ref import flash_attention_ref
        layer_errs = []
        for q, k, v, causal in qkv:
            want = flash_attention_ref(q, k, v, causal=causal).float()
            diff = (gqa_flash_attention(q, k, v, causal=causal).float()
                    - want).abs()
            layer_errs.append((diff.max().item(), bool(
                (diff <= FLASH_TOL + FLASH_RTOL * want.abs()).all())))
        del qkv
        with plain_attention(), dispatch_spy([], fast_routes):
            plain, _ = run_prefill(ccfg)
        prefill_err = logit_errs(fast, plain)
        sdpa_err = None
        if layer_errs:     # a third prefill: the attention through SDPA
            with sdpa_attention(), dispatch_spy([], fast_routes):
                sdpa, _ = run_prefill(ccfg)
            sdpa_err = logit_errs(sdpa, plain)
            del sdpa
        routes = {}
        if ccfg.num_experts:
            # the same plain prefill routing on its own
            with plain_attention(), dispatch_spy(free_routes):
                free, _ = run_prefill(ccfg)
            routes = {"prefill_unpinned_max_rel_err":
                      logit_errs(fast, free)[1],
                      "routes_agree": statistics.mean(
                          (a[0] == b[0]).all(-1).float().mean().item()
                          for a, b in zip(fast_routes, free_routes))}
            del free
        bf16_errs = teacher_forced(ccfg, cache)
        decode_errs = bf16_errs
        if exact == "auto":
            exact = max(e[1] for e in bf16_errs) > MODEL_TOL
        if exact:
            import dataclasses
            f32 = dataclasses.replace(ccfg, compute_dtype="float32")
            with plain_attention():
                _, c32 = prefill(f32, params, {"tokens": tokens, **aux},
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
           "prefill_sdpa_max_abs_err": sdpa_err and sdpa_err[0],
           "prefill_sdpa_max_rel_err": sdpa_err and sdpa_err[1],
           "prefill_flash_max_abs_err": max((e[0] for e in layer_errs),
                                            default=None),
           "finite": bool(torch.isfinite(fast).all()),
           "sample_output": out[0, P:P + 8].tolist(), "card": smi_line()}
    prefill_ok = prefill_err[1] <= MODEL_TOL or (
        sdpa_err is not None and prefill_err[1] <= SDPA_SLACK * sdpa_err[1])
    row["prefill_held_by"] = "model_tol" if prefill_err[1] <= MODEL_TOL \
        else "sdpa_slack"
    emit(row)
    if not (row["finite"] and prefill_ok
            and max(e[1] for e in decode_errs) <= MODEL_TOL
            and all(ok for _, ok in layer_errs)
            and len(layer_errs) == expect.get("gqa_flash_attention", 0)):
        raise AssertionError(f"{name}: prefill {prefill_err} (SDPA bf16 "
                             f"{sdpa_err}), decode {decode_errs} against "
                             f"{MODEL_TOL}, flash on the prefill's inputs "
                             f"{layer_errs}")
    del server, params, cache, fast, plain, aux
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


# mamba2-780m at its published widths (d 1,536, state 128, vocab 50,304),
# S1's traffic; no attention, so no flash launch
MAMBA2_ARGS = _es_args("mamba2-780m", 32, 8)
# zamba2-2.7b at its published widths (d 2,560, the shared block's 32
# heads of 80, d_ff 10,240)
ZAMBA2_ARGS = _es_args("zamba2-2.7b", 16, 4)
# arctic's smoke config (8 experts top-2, a dense residual, bf16 weights):
# the MoE step, its routing and its kernels at S1's traffic
MOE_ARGS = _es_args("arctic-480b", 32, 8, full=False)
# S1 with int8 gradient compression and error feedback
GC_ARGS = TRAIN_ARGS + ["--grad-compression"]
FAMILY_ARGS = {"train_mamba2": MAMBA2_ARGS, "train_zamba2": ZAMBA2_ARGS,
               "train_moe": MOE_ARGS, "train_gc": GC_ARGS}


PLAIN_ROWS = 8


@contextlib.contextmanager
def first_scoring_leg(rec: dict):
    """Inside: the first scoring leg's per-sample losses (the kernels'
    forward) against the plain forward (``scoring=False`` under no_grad)
    on the same batch and weights, taken inside the leg, before the step
    updates the weights, into ``rec``; the plain forward launches no
    kernel. It runs ``PLAIN_ROWS`` rows at a time: its float32 logits and
    their logsumexp's temporaries at seamless's vocab (256,256) and 32
    rows of 512 would take 50 GB."""
    from repro_torch.core import engine
    inner = engine.lm_per_sample_loss

    def spy(cfg, params, batch, *, scoring=False, **kw):
        out = inner(cfg, params, batch, scoring=scoring, **kw)
        if scoring and "err" not in rec:
            rows = batch["tokens"].shape[0]
            with torch.no_grad():
                plain = torch.cat([inner(
                    cfg, params, {k: v[lo:lo + PLAIN_ROWS]
                                  for k, v in batch.items()},
                    scoring=False)[0]
                    for lo in range(0, rows, PLAIN_ROWS)])
            rec["err"] = (out[0] - plain).abs().max().item()
            rec["finite"] = bool(torch.isfinite(out[0]).all())
            rec["losses"] = out[0][:4].tolist()
        return out
    engine.lm_per_sample_loss = spy
    try:
        yield rec
    finally:
        engine.lm_per_sample_loss = inner


def check_scoring(name: str, rec: dict) -> None:
    if not (rec.get("finite") and rec["err"] <= MODEL_TOL):
        raise AssertionError(f"{name}: scoring forward against the "
                             f"plain forward: {rec}")


def scoring_watch(tr):
    """A ``phase_path`` watch: ``first_scoring_leg`` over the run; after
    it, the scoring and training legs of one more step
    (``family_legs``)."""
    rec = {}
    watch = first_scoring_leg(rec)
    watch.__enter__()

    def check(tr, out):
        watch.__exit__(None, None, None)
        name = tr.tc.arch + ("" if tr.tc.smoke else " full")
        emit({"phase": "scoring_check", "arch": name, **rec,
              "legs": family_legs(tr), "card": smi_line()})
        check_scoring(name, rec)
    return check


def family_legs(tr) -> dict:
    """``step_legs`` at the trainer's shapes, on its first batch."""
    return step_legs(tr.engine, tr.state,
                     tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0))))


def step_legs(eng, st, batch) -> dict:
    """The scoring leg (no-grad forward with the kernels, the store
    update) and the training leg (forward + backward of the minibatch) of
    one serial-ES step on ``batch``: host clock to a device sync (median
    of 3) and device time (torch.profiler, 2 calls)."""
    from repro_torch.core.selection import select_minibatch
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


# the family paths' depth, cut to pay for phase mesh_ssm: mamba2-780m 48
# -> 16 layers, zamba2-2.7b 9 sites of 6 -> 3 (18 Mamba2 layers and 3 of
# the shared block's flash launches a scoring leg)
FAMILY_DEPTH = {"train_mamba2": {"num_layers": 16},
                "train_zamba2": {"num_layers": 18}}


def phase_family(name: str) -> dict:
    import dataclasses
    from repro_torch.configs import get_config
    cfg = None
    if name in FAMILY_DEPTH:
        arch = FAMILY_ARGS[name][FAMILY_ARGS[name].index("--arch") + 1]
        cfg = dataclasses.replace(get_config(arch), **FAMILY_DEPTH[name])
    return phase_path(name, FAMILY_ARGS[name], FAMILY_WATCH[name], cfg)


def grok1_cut():
    """grok-1-314b at its published widths (d 6,144, 48 heads of 128 over
    8 kv heads, 8 experts of d_ff 32,768, top-2, vocab 131,072), depth cut
    64 -> 2 layers to fit one card in float32."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("grok-1-314b"), num_layers=2)


def phase_serve_mamba2() -> dict:
    """mamba2-780m at full width, 16 of 48 layers, 16 tokens (64 tokens
    and 48 layers until the mesh phases needed the script's time): no
    attention, so the prefill launches no kernel (and nothing else does).
    Decode is held to the forward in float32 (``phase_serve``'s
    ``exact``)."""
    import dataclasses
    from repro_torch.configs import get_config
    return phase_serve("serve_mamba2", dataclasses.replace(
        get_config("mamba2-780m"), num_layers=16), gen=16, expect={},
        exact=True)


def phase_serve_moe() -> dict:
    """grok-1 at published widths, 2 layers: one flash launch a layer in
    the prefill (hd 128, 48:8). 16 tokens. The checks run with a dropless
    capacity factor (= num_experts): a decode step routes its 8 tokens,
    the full forward 8 x (P + t), and only without drops do the two route
    alike (``tests/test_decode.py:28-35``); the plain prefill takes the
    kernel run's routes and decode is held to the forward in float32
    (``phase_serve``). The prefill's logits differed from the plain
    prefill's by ~0.12 (routes pinned; 0.155 not), past the 5e-2 bound:
    they are held to the SDPA-bf16 prefill's gap (``SDPA_SLACK``), and
    the kernel on the prefill's own (q, k, v) of both layers."""
    import dataclasses
    cfg = grok1_cut()
    return phase_serve("serve_moe", cfg, gen=16,
                       expect={"gqa_flash_attention": cfg.num_layers},
                       check_cfg=dataclasses.replace(
                           cfg, capacity_factor=float(cfg.num_experts)),
                       exact=True)


# ---------------------------------------------------------------------------
# phase 6d: the vlm and encdec families through the ES engine and the server
# ---------------------------------------------------------------------------

def set_gates(params: dict, seed: int) -> None:
    """The vlm's cross-block gates drawn uniform in +-0.5, in place: at
    init they are 0 and tanh(0) = 0 cuts the cross path off."""
    g = _gen(seed)
    for name in ("gate_attn", "gate_mlp"):
        x = params["cross"][name]
        x.copy_(torch.rand(x.shape, device=x.device, generator=g) - 0.5)


def vlm_one_site():
    """llama-3.2-vision-11b at its published widths (d 4,096, 32 heads of
    128 over 8, d_ff 14,336, vocab 128,256, 1,600 image tokens), depth cut
    40 -> 5: one site of 5 self-attention layers and its gated cross
    block, 2.36 B parameters, 37.7 GB of float32 weights, gradients and
    AdamW moments (two sites, 58.7 GB, leave too little room for the
    scoring leg's cross-attention scores)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama-3.2-vision-11b"),
                               num_layers=5)


def seamless():
    """seamless-m4t-large-v2 at its published widths (d 1,024, 16 heads of
    64, d_ff 8,192, vocab 256,256, LayerNorm, GELU), depth cut 24 + 24 ->
    12 encoder and 12 decoder layers (to pay for phase mesh_ssm)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("seamless-m4t-large-v2"),
                               num_layers=12, num_encoder_layers=12)


# engine traffic: S1's (serial ES, meta-batch 32, minibatch 8, S 512, the
# synthetic source's tokens), 4 steps, the memory drawn on the device in
# bf16 each step: seamless's frames (32, encoder_len(512) = 128, 1,024),
# llama-3.2-vision's image embeddings (32, 1,600, 4,096)
ENGINE_META, ENGINE_MINI, ENGINE_S, ENGINE_STEPS = 32, 8, 512, 4
ENGINE_PATHS = {"train_encdec": seamless, "train_vlm": vlm_one_site}
# a scoring leg's launches: one flash a self-attention layer (seamless: 24
# encoder, non-causal at S 128, and 24 decoder), one xent call, one store
# update; cross-attention is plain PyTorch
ENGINE_UNIT = {"train_encdec": {"fused_xent": 1, "gqa_flash_attention": 24,
                                "fused_score_update": 1},
               "train_vlm": {"fused_xent": 1, "gqa_flash_attention": 5,
                             "fused_score_update": 1}}


def phase_engine(name: str) -> dict:
    """``name``'s config through ``ESEngine.scheduled_step`` (the
    trainer's serial step; the trainer refuses these families: no source
    makes their stubs), 4 steps on the card from ``init_train_state``
    (the vlm's gates drawn non-zero), every launch count set to 0 just
    before and read just after: each step launches ``ENGINE_UNIT``. The
    first scoring leg is held to the plain forward (``MODEL_TOL``); then
    the legs of one more step (``step_legs``), the peak and the steps'
    times (host clock to the loss's read)."""
    import numpy as np
    from repro_torch.core.engine import ESConfig, ESEngine, init_train_state
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.models.model import encoder_len, image_tokens
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.schedule import get_schedule
    cfg = ENGINE_PATHS[name]()
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    es_cfg = ESConfig(method="es", minibatch=ENGINE_MINI, n_train=1024)
    opt = OptConfig(lr=1e-3)
    eng = ESEngine(cfg, es_cfg, opt, get_schedule(
        "cosine", ENGINE_STEPS, warmup_steps=ENGINE_STEPS // 2))
    st = init_train_state(cfg, es_cfg, opt, 0, "cuda",
                          meta_batch=ENGINE_META)
    if cfg.family == "vlm":
        set_gates(st.params, seed=1)
        key, shape = "image_embeds", (image_tokens(cfg), cfg.d_model)
    else:
        key, shape = "frames", (encoder_len(cfg, ENGINE_S),
                                cfg.frontend_dim or cfg.d_model)
    ds = SyntheticLM(SyntheticConfig(n_samples=1024, seq_len=ENGINE_S,
                                     vocab_size=64, seed=0))
    g = _gen(3)

    def batch(step: int) -> dict:
        ids = np.arange(step * ENGINE_META, (step + 1) * ENGINE_META)
        out = {k: torch.as_tensor(v, device="cuda")
               for k, v in ds.batch(ids).items()}
        out[key] = torch.randn((ENGINE_META,) + shape, generator=g,
                               device="cuda", dtype=torch.bfloat16)
        return out
    rec, losses, step_ms = {}, [], []
    with first_scoring_leg(rec):
        # the plain forward of the check runs inside the first step
        for fn in wrappers.values():
            fn.launches = 0
        for step in range(ENGINE_STEPS):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = eng.scheduled_step(st, b)
            losses.append(float(m["loss"]))           # a device sync
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    legs = step_legs(eng, st, batch(0))
    row = {"phase": name, "arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers, key: list(shape),
           "meta_batch": ENGINE_META, "minibatch": ENGINE_MINI,
           "seq_len": ENGINE_S, "losses": losses, "step_ms": step_ms,
           "median_step_ms_after_first": statistics.median(step_ms[1:]),
           "max_memory_allocated": peak,
           "param_count": sum(x.numel() for x in tree_leaves(st.params)),
           "launches": launches, "scoring_check": rec, "legs": legs,
           "card": smi_line()}
    emit(row)
    _expect(name, launches, {k: v * ENGINE_STEPS
                             for k, v in ENGINE_UNIT[name].items()})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    check_scoring(name, rec)
    del eng, st
    torch.cuda.empty_cache()
    return launches


def phase_serve_vlm() -> dict:
    """llama-3.2-vision-11b at its published widths, depth cut 40 -> 10
    (2 sites of 5, to pay for phase mesh_ssm), gates non-zero, 16 tokens:
    10 flash launches a prefill (GQA 32:8, hd 128); the 2 gated cross
    blocks are plain. Decode held in bf16 where it meets MODEL_TOL, else
    in float32 (``exact="auto"``)."""
    import dataclasses
    from repro_torch.configs import get_config
    return phase_serve("serve_vlm", dataclasses.replace(
        get_config("llama-3.2-vision-11b"), num_layers=10), gen=16,
        exact="auto", gates=True)


def phase_serve_encdec() -> dict:
    """seamless-m4t-large-v2 at its published widths, 12 + 12 of 24 + 24
    layers (``seamless``), 16 tokens: 24 flash launches a prefill (the
    encoder's 12 over 128 frames without the causal mask, the decoder's
    12); the encoder runs once a ``generate``, in the prefill."""
    return phase_serve("serve_encdec", seamless(), gen=16, exact="auto")


# ---------------------------------------------------------------------------
# phase 6e: the sharded score store through the trainer (row blocks)
# ---------------------------------------------------------------------------

SHARDED_BLOCKS = 4
# S1's traffic with the store in four row blocks (SH), and B's (S1 with
# the int8 store, n 65,536) with the int8 wire (SHQ); the card is one
# device, so the trainer's device list is replaced by four blocks on it
SHARDED_ARGS = {"train_sharded": TRAIN_ARGS + ["--shard-scores"],
                "train_sharded_quant": QUANT_ARGS + ["--shard-scores",
                                                     "--quant-wire"]}


@contextlib.contextmanager
def blocks_on_card(n: int = SHARDED_BLOCKS):
    """The trainer's device list (``sharding.local_devices``) replaced by
    ``n`` row blocks on cuda:0."""
    from repro_torch.distributed import sharding
    real = sharding.local_devices
    sharding.local_devices = lambda device: [torch.device("cuda", 0)] * n
    try:
        yield
    finally:
        sharding.local_devices = real


class StoreTap:
    """The engine's store, recording each update (ids, losses, betas),
    gather (ids and the values it gave) and selection (weights, k, the
    generator's state before it, the ids it gave) in order."""

    def __init__(self, store):
        self.store = store
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.store, name)

    def update(self, scores, ids, losses, beta1, beta2, *, fused=True):
        self.calls.append(("update", ids.clone(), losses.clone(), beta1,
                           beta2))
        return self.store.update(scores, ids, losses, beta1, beta2,
                                 fused=fused)

    def gather(self, scores, ids):
        s, w = self.store.gather(scores, ids)
        self.calls.append(("gather", ids.clone(), s.clone(), w.clone()))
        return s, w

    def select(self, weights, k, *, generator=None, gumbel=None):
        state = generator.get_state()
        out = self.store.select(weights, k, generator=generator,
                                gumbel=gumbel)
        self.calls.append(("select", weights.clone(), k, state, out.clone()))
        return out


def wire_select_errors(weights, k: int, state, got) -> int:
    """Ids that a wire selection decides otherwise than the exact keys do
    by more than one key-grid step (each block's candidate span / 127,
    the widest block's): an id whose key is above the k-th by more than a
    step must be kept, one below it by more than a step must not."""
    from repro_torch.core.selection import sample_gumbel
    g = torch.Generator(device="cuda")
    g.set_state(state)
    keys = torch.log(torch.clamp(weights.float(), min=1e-20)) + \
        sample_gumbel(weights.shape, g, weights.device)
    B = keys.shape[0]
    m = min(k, B // SHARDED_BLOCKS)
    top = keys.reshape(SHARDED_BLOCKS, -1).sort(dim=1, descending=True).values
    step = float(((top[:, 0] - top[:, m - 1]) / 127.0).max())
    kth = float(keys.sort(descending=True).values[k - 1])
    keys, sel = keys.tolist(), set(got.tolist())
    return sum(1 for i, x in enumerate(keys)
               if (x > kth + step and i not in sel)
               or (x < kth - step and i in sel))


def store_leg_timings(quant: bool, n: int) -> dict:
    """One scoring step's store work at the path's shape (B 32: a gather,
    the update, the Gumbel top-k of 8) on the replicated store and on
    four row blocks on the card (int8: also with the wire), after the
    path: device ms and launches a step (torch.profiler), the update's
    kernels alone (their device ms and launches a step), and the host
    clock."""
    from repro_torch.core import scores
    g = _gen(3)
    ids = torch.randperm(n, generator=g, device="cuda")[:32].to(torch.int32)
    losses = 3 * torch.rand(32, generator=g, device="cuda")
    gum = -torch.log(-torch.log(torch.rand(
        32, generator=g, device="cuda").clamp(min=1e-30)))
    blocks = scores.ScoreSharding([torch.device("cuda", 0)] * SHARDED_BLOCKS)
    runs = [("replicated", None, False), ("blocks", blocks, False)]
    if quant:
        runs.append(("blocks_wire", blocks, True))
    out = {}
    for name, ss, wire in runs:
        st = scores.make_store(ss, quantize=quant, block=1024,
                               residual_rows=1024, wire=wire)
        leaf = st.init_leaf(n, "cuda")

        def update():
            st.update(leaf, ids, losses, 0.2, 0.9)

        def leg():
            w = st.gather(leaf, ids)[1]
            update()
            st.select(w, 8, gumbel=gum)

        trace = device_trace(leg)
        kern = [e for e in _device_rows(update, 20)
                if "score_update" in e.key or "quant_" in e.key]
        out[name] = {
            "device_ms": trace["device_ms"],
            "launches": trace["launches_per_call"],
            "update_kernels_device_ms": sum(
                e.self_device_time_total for e in kern) / 1e3 / 20,
            "update_kernel_launches": sum(e.count for e in kern) / 20,
            "host_ms": wall_ms(leg, 50, warmup=2)}
        del st, leaf
    return out


def sharded_watch(name: str, tr):
    """Check of SH and SHQ: the store is in four blocks on the card, and
    the engine's store calls are recorded; after the run (its launch
    counts already read) the recorded updates are replayed into a
    replicated store of the same kind on the card. f32: every gather, the
    selections (from the generator's recorded state), and the rows
    (blocks concatenated) bitwise the replay's. int8 with the wire: each
    wire gather within one int8 grid step of the replay's, each wire
    selection by ``wire_select_errors``; the codes and scales bitwise, no
    live residual evicted; every updated row read through the wire within
    one grid step of the replay's, and with the wire off bitwise."""
    import dataclasses

    from repro_torch.core import scores
    ss = tr.score_sharding
    if ss is None or ss.devices != (torch.device("cuda", 0),) \
            * SHARDED_BLOCKS:
        raise AssertionError(f"sharded path: store layout {ss}")
    tap = StoreTap(tr.store)
    tr.engine.store = tap
    quant = isinstance(tr.store, scores.QuantizedStore)

    def check(tr, out):
        if not out["score_store_sharded"]:
            raise AssertionError("sharded path: summary says replicated")
        torch.cuda.synchronize()
        rep = scores.make_store(None, quantize=quant, block=1024,
                                residual_rows=1024)
        leaf = rep.init_leaf(tr.n_train, "cuda")
        counts = {"update": 0, "gather": 0, "select": 0}
        worst, wrong_sel, ids_all = 0.0, 0, []
        for call in tap.calls:
            counts[call[0]] += 1
            if call[0] == "update":
                rep.update(leaf, *call[1:])
                ids_all.append(call[1])
            elif call[0] == "gather":
                for got, want in zip(call[2:], rep.gather(leaf, call[1])):
                    if quant:
                        err = float((got - want).abs().max())
                        worst = max(worst, err)
                        if err > float(want.abs().max()) / 127.0 + 1e-7:
                            raise AssertionError(
                                f"SHQ: wire gather off by {err}")
                    elif not torch.equal(got, want):
                        raise AssertionError("SH: gather differs from the "
                                             "replicated replay's")
            else:
                weights, k, state, got = call[1:]
                if quant:
                    wrong_sel += wire_select_errors(weights, k, state, got)
                    continue
                g = torch.Generator(device="cuda")
                g.set_state(state)
                if not torch.equal(got, rep.select(weights, k, generator=g)):
                    raise AssertionError("SH: selection differs from the "
                                         "replicated replay's")
        got = tr.state.scores
        fields = ("s_q", "w_q", "seen_q", "s_scale", "w_scale") if quant \
            else ("s", "w", "seen")
        for f in fields:
            if not torch.equal(torch.cat(getattr(got, f)),
                               getattr(leaf, f)):
                raise AssertionError(f"sharded path: {f} differs from the "
                                     f"replicated replay's")
        updated = None
        if quant:
            ids = torch.cat(ids_all)
            live = sum(int((b > 0).sum()) for b in got.err_seq)
            exact = dataclasses.replace(tr.store, wire=False)
            want = rep.gather(leaf, ids)
            same = all(torch.equal(a, b) for a, b in zip(
                exact.gather(got, ids), want))
            # the run's own gathers read rows still at the prior, which
            # the wire carries exactly: the updated rows test its grid
            updated = {}
            for f, a, b in zip(("s", "w"), tr.store.gather(got, ids), want):
                err, bound = float((a - b).abs().max()), \
                    float(b.abs().max()) / 127.0 + 1e-7
                updated[f] = {"worst_abs_err": err, "bound": bound}
                if err > bound:
                    raise AssertionError(f"SHQ: wire gather of the updated "
                                         f"rows' {f} off by {err} > {bound}")
            if live != ids.numel() or not same or wrong_sel:
                raise AssertionError(
                    f"SHQ: live residuals {live} of {ids.numel()}, wire-off "
                    f"gathers equal: {same}, selections off by more than a "
                    f"key-grid step: {wrong_sel}")
        emit({"phase": f"{name}_check",
              "calls": counts, "blocks": ss.n_shards,
              "wire_gather_worst_abs_err": worst if quant else None,
              "wire_gather_updated_rows": updated,
              "replay": "bitwise",
              "store_leg": store_leg_timings(quant, tr.n_train),
              "card": smi_line()})
        del leaf
    return check


def phase_sharded(name: str) -> dict:
    """SH or SHQ through the trainer the CLI builds, the store in four
    row blocks on the card."""
    with blocks_on_card():
        return phase_path(name, SHARDED_ARGS[name],
                          watch=partial(sharded_watch, name))


# ---------------------------------------------------------------------------
# phase dryrun: the dry run's predictions held to the card's measured step
# ---------------------------------------------------------------------------

MiB = 1 << 20
PEAK_SLACK = (0.05, 256 * MiB)   # peak within 5 % or 256 MiB, the larger
SHARE_MAX = 1.05                 # bound / device time above it: miscounted


def dryrun_cells() -> dict:
    """name -> (arch, ShapeConfig, minibatch, launches of the measured
    step): D1 (S1's traffic through ``es_step``), D2 (SV's prefill and
    one decode step on its cache of 512 + 64), D3 (the reference's
    mamba2-780m x long_500k; zamba2-2.7b's when the dry run says it
    fits), all at full width and depth."""
    from repro_torch.configs.base import LONG_500K, ShapeConfig
    P = SERVE_P + SERVE_GEN
    return {
        "D1": ("qwen1.5-0.5b", ShapeConfig("s1", 512, 32, "train"), 8,
               {"gqa_flash_attention": 24, "fused_xent": 1,
                "fused_score_update": 1}),
        "D2_prefill": ("qwen1.5-0.5b", ShapeConfig("sv_prefill", SERVE_P,
                                                   SERVE_B, "prefill"),
                       None, {"gqa_flash_attention": 24}),
        "D2_decode": ("qwen1.5-0.5b", ShapeConfig("sv_decode", P, SERVE_B,
                                                  "decode"), None, {}),
        "D3": ("mamba2-780m", LONG_500K, None, {}),
        "D3_zamba2": ("zamba2-2.7b", LONG_500K, None, {}),
    }


def _finite(out, kind: str) -> bool:
    """The step's result finite: a train step's losses, a prefill's or
    decode step's logits (not the cache it also returns)."""
    got = [out[1]["loss"], out[1]["sel_loss"]] if kind == "train" \
        else [out[0]]
    return all(bool(torch.isfinite(t).all()) for t in got)


def dryrun_cell(name: str, arch: str, shape, minibatch, unit: dict,
                wrappers: dict) -> dict:
    """Predict one cell on ``meta`` with ``run_cell``'s machinery, then
    run the same step on the card: a warm-up step, then one step under
    the same counter (every launch count 0 just before, read just after;
    the peak reset before, read after), then the profiler's device time
    of one more."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import CostCounter, roofline_terms
    cfg = get_config(arch)
    t0 = time.perf_counter()
    pred = dryrun.count(dryrun.prepare(cfg, shape, minibatch=minibatch))
    trace_s = time.perf_counter() - t0
    row = {"cell": name, "arch": arch, "shape": list(
        (shape.name, shape.seq_len, shape.global_batch, shape.kind)),
        "minibatch": minibatch, "trace_s": round(trace_s, 3),
        "predicted": {k: pred[k] for k in ("flops", "flops_by_dtype",
                                           "bytes", "memory",
                                           "fits_one_card", "roofline")}}
    if not pred["fits_one_card"]:
        row["skipped"] = "the dry run says it does not fit one card"
        return row
    torch.cuda.empty_cache()
    prep = dryrun.prepare(cfg, shape, device="cuda", minibatch=minibatch)
    prep.step()                                # warm-up
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with CostCounter() as counter:
        out = prep.step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    finite = _finite(out, shape.kind)
    del out
    device_ms = device_trace(prep.step, reps=1)["device_ms"]
    real = roofline_terms(flops_by_dtype=counter.flops,
                          bytes_per_chip=counter.bytes)
    want_peak = pred["memory"]["peak_bytes"]
    slack = max(PEAK_SLACK[0] * want_peak, PEAK_SLACK[1])
    share = pred["roofline"]["step_s_lower_bound"] * 1e3 / device_ms
    row.update({
        "measured": {"flops": counter.total_flops,
                     "flops_by_dtype": {str(k).replace("torch.", ""): v
                                        for k, v in counter.flops.items()},
                     "bytes": counter.bytes,
                     "peak_bytes": peak,
                     "peak_minus_predicted": peak - want_peak,
                     "device_ms": device_ms,
                     "step_s_lower_bound": real["step_s_lower_bound"]},
        "roofline_share": share, "launches": launches,
        "card": smi_line()})
    emit({"phase": "dryrun", **row})
    if counter.total_flops != pred["flops"] or \
            row["measured"]["flops_by_dtype"] != pred["flops_by_dtype"]:
        raise AssertionError(f"{name}: the card's step counts "
                             f"{counter.total_flops} FLOPs, the meta trace "
                             f"{pred['flops']}")
    if abs(peak - want_peak) > slack:
        raise AssertionError(f"{name}: peak {peak} B against the predicted "
                             f"{want_peak} B (slack {slack:.0f})")
    if share > SHARE_MAX:
        raise AssertionError(f"{name}: roofline share {share:.3f} > "
                             f"{SHARE_MAX}: the bound miscounts the step")
    if not finite:
        raise AssertionError(f"{name}: non-finite outputs")
    for k in wrappers:
        if launches[k] != unit.get(k, 0):
            raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                 f"times, expected {unit.get(k, 0)}")
    del prep
    torch.cuda.empty_cache()
    return row


def phase_dryrun() -> dict:
    """The dry run (``repro_torch.launch.dryrun``) on the card: each cell
    of ``dryrun_cells`` predicted on ``meta``, then measured. Fails when
    the card's FLOP count is not the meta count, the measured peak is off
    by more than 5 % or 256 MiB (the larger), a roofline share exceeds
    1.05, an output is not finite or a launch count is off. Returns the
    measured steps' launches."""
    wrappers = _wrappers()
    launches = {k: 0 for k in wrappers}
    for name, (arch, shape, mb, unit) in dryrun_cells().items():
        row = dryrun_cell(name, arch, shape, mb, unit, wrappers)
        if "skipped" in row:
            emit({"phase": "dryrun", **row})
            continue
        for k, v in row["launches"].items():
            launches[k] += v
    return launches


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
    prefetch on and off, in turns (on, off, off, on), 6 steps each (10
    until the MoE mesh phase needed the script's time): the
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
        run_args = args + ["--max-steps", "6"]
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


# a knob run's steps (its path's 4, cut to pay for phase mesh_ssm: the
# peak is a first step's, the median step needs a second)
KNOB_STEPS = 2


def _knob_run(args, knobs: str) -> dict:
    """One trainer run of ``args`` (KNOB_STEPS steps) with ``knobs``: its
    peak device memory, median step after the first and losses; then its
    training leg (and, serial ES, its scoring leg) on the first batch,
    median of 3."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _knob_trainer(args + ["--max-steps", str(KNOB_STEPS)], knobs)
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
    """The four paths whose training leg the knobs bound, each run once
    with the knobs off and once on, in one call, and ``train`` also with
    remat "full" (the peaks repeat to the byte, so one run a setting
    holds them). Each run's losses must be finite, and the knobs on must
    lower each path's peak. (Path A at meta-batch 32, which fits only
    with the knobs on, is path ``train_packed_mb32``.)
    """
    rows = {}
    for name in MEMORY_PATHS:
        order = ("off", "on") + (("full",) if name == "train" else ())
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
# phase 11b: the store's rows owned per process, two processes on the card
# ---------------------------------------------------------------------------

CLUSTER_N = 1 << 24          # rows; each of 2 processes owns 2^23
CLUSTER_B, CLUSTER_T = 32, 16
CLUSTER_GROW = 1 << 21       # the int8 store's grow (2 blocks of 1,024)
CLUSTER_K = 8


def _digest(*arrays) -> str:
    import hashlib

    import numpy as np
    h = hashlib.sha1()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def cluster_stream(n: int, seed: int, steps: int):
    """(ids, losses) on the card: B distinct ids a step (the reference's
    ``tests/test_multihost.py`` workload)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (torch.from_numpy(rng.choice(n, CLUSTER_B, replace=False)
                                .astype(np.int32)).cuda(),
               torch.from_numpy(rng.uniform(0.1, 3.0, CLUSTER_B)
                                .astype(np.float32)).cuda())


def _cat(x):
    return torch.cat(x) if isinstance(x, list) else x


def cluster_run(rank: int, world: int, ckpt_dir=None) -> tuple:
    """The workload both topologies run -> (result, times, f32 store, its
    leaf). world 1: replicated stores; world 2: this process's half of
    the rows in two blocks on cuda:0, completed through the host
    collectives. The f32 store: 16 steps of gathers and updates, a
    selection, a fill of every row (distinct values), the five prune
    methods, a partitioned checkpoint (world 2); the int8 store: 16 steps
    of updates and gathers, its assembled losses, a grow and 4 more
    steps. Digests of what every process must see alike, the local rows'
    digests, and (world 2) the times of the host legs."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import scores
    from repro_torch.core.pruning import prune_epoch_snapshot
    from repro_torch.distributed.hostcomm import get_comm
    comm = get_comm()
    half = CLUSTER_N // world

    def layout(n_global):
        if world == 1:
            return None
        return scores.ScoreSharding([torch.device("cuda", 0)] * 2,
                                    n_global=n_global,
                                    offset=rank * n_global // world)

    res, times = {}, {}
    st = scores.make_store(layout(CLUSTER_N))
    leaf = st.init_leaf(CLUSTER_N, "cuda")
    gathers = []
    for ids, losses in cluster_stream(CLUSTER_N, 0, CLUSTER_T):
        gathers += list(st.gather(leaf, ids))
        st.update(leaf, ids, losses, 0.2, 0.9)
    res["gathers"] = _digest(*gathers)
    w = st.gather(leaf, torch.arange(CLUSTER_B, dtype=torch.int32,
                                     device="cuda"))[1]
    gum = torch.from_numpy(np.random.default_rng(7).gumbel(
        size=CLUSTER_B).astype(np.float32)).cuda()
    res["sel"] = st.select(w, CLUSTER_K, gumbel=gum).tolist()
    # every row scored once more with betas 0 (s = w = the loss), the
    # losses the 2^24 float32 values from 1.0 up: no two rows tie, so the
    # top-k of UCB and KA cannot depend on the candidates' order
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randperm(CLUSTER_N, generator=g, device="cuda").to(
        torch.int32)
    vals = (torch.arange(CLUSTER_N, dtype=torch.int32, device="cuda")
            + 0x3F800000).view(torch.float32)
    for lo in range(0, CLUSTER_N, 1 << 20):
        st.update(leaf, ids[lo:lo + (1 << 20)], vals[lo:lo + (1 << 20)],
                  0.0, 0.0)
    rows = [_cat(getattr(leaf, f)) for f in ("s", "w", "seen")]
    res["store_bytes"] = sum(r.numel() * r.element_size() for r in rows)
    if comm is not None:
        x = np.zeros(CLUSTER_B, np.float32)
        rt = []
        for _ in range(20):
            t0 = time.perf_counter()
            comm.allreduce_sum(x)
            rt.append((time.perf_counter() - t0) * 1e3)
        times["gather_round_trip_ms"] = statistics.median(rt)
        real, legs = comm.allgather, []

        def timed_allgather(arr):
            t0 = time.perf_counter()
            out = real(arr)
            legs.append((time.perf_counter() - t0, int(np.asarray(
                arr).nbytes)))
            return out
        comm.allgather = timed_allgather
    t0 = time.perf_counter()
    snap = st.prune_snapshot(leaf)
    times["snapshot_s"] = time.perf_counter() - t0
    prev = np.random.default_rng(1).uniform(0.05, 3.0, CLUSTER_N).astype(
        np.float32)
    res["prune"], times["prune"] = {}, {}
    for m in ("eswp", "infobatch", "ucb", "ka", "random"):
        if comm is not None:
            legs.clear()
        t0 = time.perf_counter()
        r = prune_epoch_snapshot(m, np.random.default_rng(3), snap,
                                 prev_losses=prev, ratio=0.25)
        dt = time.perf_counter() - t0
        res["prune"][m] = [_digest(np.sort(r.kept)),
                           None if r.grad_scale is None
                           else _digest(r.grad_scale)]
        times["prune"][m] = {"decide_s": dt} if comm is None else {
            "decide_s": dt, "comm_s": sum(x[0] for x in legs),
            "comm_bytes_sent": sum(x[1] for x in legs)}
    res["full_losses"] = _digest(snap.full_losses())
    if comm is not None:
        comm.allgather = real
    if ckpt_dir is not None:
        ck = Checkpointer(ckpt_dir)
        ck.save({"scores": st.leaf_state(leaf)}, step=CLUSTER_T,
                partition=st.checkpoint_partition())
        times["checkpoint_write"] = ck.timings[-1]

    q = scores.make_store(layout(CLUSTER_N), quantize=True, block=1024,
                          residual_rows=1024)
    qs = q.init_leaf(CLUSTER_N, "cuda")
    gathers = []
    for ids, losses in cluster_stream(CLUSTER_N, 2, CLUSTER_T):
        q.update(qs, ids, losses, 0.2, 0.9)
        gathers += list(q.gather(qs, ids))
    res["q_gathers"] = _digest(*gathers)
    res["q_full_losses"] = _digest(q.prune_snapshot(qs).full_losses())
    if comm is not None:
        every = torch.cat([ids for ids, _ in cluster_stream(
            CLUSTER_N, 2, CLUSTER_T)])
        exact = q.gather(qs, every)[0]
        wired = dataclasses.replace(q, wire=True).gather(qs, every)[0]
        err = float((wired - exact).abs().max())
        if err > float(exact.abs().max()) / 127.0 + 1e-7:
            raise AssertionError(f"cluster: wire gather off by {err}")
        times["wire_gather_worst_abs_err"] = err
    q, qs = q.grow(qs, CLUSTER_GROW)
    n2 = CLUSTER_N + CLUSTER_GROW
    gathers = []
    for ids, losses in cluster_stream(n2, 4, 4):
        q.update(qs, ids, losses, 0.2, 0.9)
        gathers += list(q.gather(qs, ids))
    res["q_grown_gathers"] = _digest(*gathers)
    res["q_store_bytes"] = sum(_cat(getattr(qs, f.name)).numel()
                               * _cat(getattr(qs, f.name)).element_size()
                               for f in dataclasses.fields(qs))
    codes = [_cat(getattr(qs, f)) for f in ("s_q", "w_q", "seen_q")]
    scl = [_cat(getattr(qs, f)) for f in ("s_scale", "w_scale")]
    h2, nb2 = n2 // 2, n2 // 2 // 1024
    if world == 1:
        res["q_rows"] = [_digest(*(c[p * h2:(p + 1) * h2] for c in codes),
                                 *(s[p * nb2:(p + 1) * nb2] for s in scl))
                         for p in range(2)]
    else:
        res["q_rows"] = _digest(*codes, *scl)
    if world == 2:
        res["rows"] = _digest(*rows)
    else:
        res["rows"] = [_digest(*(r[p * half // 2:(p + 1) * half // 2]
                                 for r in rows)) for p in range(2)]
    return res, times, st, leaf


def cluster_child(rank: int, port: int, ckpt_dir: str) -> None:
    """``--cluster-child RANK PORT DIR``: one process of phase
    ``cluster``. Process 0 stands up the ``TCPStore`` on ``port``; both
    join a gloo group of two over it (``get_comm`` finds its store), run
    ``cluster_run`` on half the rows and print one JSON line."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    res, times, _, _ = cluster_run(rank, 2, ckpt_dir)
    emit({"cluster_child": rank, "result": res, "times": times})
    dist.destroy_process_group()


def phase_cluster() -> None:
    """Two processes share cuda:0, each owning 2^23 of 2^24 rows in two
    row blocks, their host legs through ``HostComm`` over the gloo group's
    store; meanwhile this process runs the same workload on replicated
    stores on the card. Every result (gathers, the selection, the five
    prune methods' kept-sets, grad scales and s-snapshots, the int8
    store's gathers before and after its grow and its assembled losses)
    must be bitwise this run's, and each process's rows its range; the
    partitioned checkpoint both wrote is restored here onto a replicated
    and onto a four-block template, bitwise this run's store. A child
    that fails fails the phase."""
    import shutil
    import socket
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import scores
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d = tempfile.mkdtemp()
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cluster-child",
         str(r), str(port), d], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        ref, ref_times, st, leaf = cluster_run(0, 1)
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    try:
        children_s = time.perf_counter() - t0
        got = []
        for r, (p, o) in enumerate(zip(procs, outs)):
            lines = [json.loads(x) for x in o.splitlines()
                     if x.startswith('{"cluster_child"')]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"cluster: process {r} failed "
                                     f"(rc {p.returncode}):\n{o[-4000:]}")
            got.append(lines[-1])
        differ = []
        for r, g in enumerate(got):
            for k, v in ref.items():
                want = v[r] if k in ("rows", "q_rows") else v
                if k not in ("store_bytes", "q_store_bytes") \
                        and g["result"][k] != want:
                    differ.append((r, k))
        restored = {}
        for name, store in (("replicated", scores.make_store(None)),
                            ("four_blocks", scores.make_store(
                                scores.ScoreSharding(
                                    [torch.device("cuda", 0)] * 4)))):
            like = store.init_leaf(CLUSTER_N, "cuda")
            back = store.load_leaf_state(Checkpointer(d).restore(
                {"scores": store.leaf_state(like)}, step=CLUSTER_T)[
                    "scores"], like)
            restored[name] = all(torch.equal(_cat(getattr(back, f)),
                                             getattr(leaf, f))
                                 for f in ("s", "w", "seen"))
        emit({"phase": "cluster", "n": CLUSTER_N, "processes": 2,
              "blocks_per_process": 2, "steps": CLUSTER_T,
              "differing": differ, "restored_bitwise": restored,
              "children_s": children_s,
              "times": [g["times"] for g in got],
              "store_bytes": [g["result"]["store_bytes"] for g in got],
              "int8_store_bytes": [g["result"]["q_store_bytes"]
                                   for g in got],
              "one_process": {"store_bytes": ref["store_bytes"],
                              "int8_store_bytes": ref["q_store_bytes"],
                              "times": ref_times},
              "card": smi_line()})
        if differ or not all(restored.values()):
            raise AssertionError(f"cluster: differs from the one-process "
                                 f"run: {differ}, restored {restored}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        del st, leaf
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase mesh: the dense model sharded over a (2, 2) mesh of four processes
# ---------------------------------------------------------------------------

MESH_SHAPE, MESH_NAMES = (2, 2), ("data", "model")
MESH_MB = 8                       # S1's minibatch
# a rank's updated state against the one-process run: the first and
# second moments (the step's clipped gradient x 0.1, its square x 0.05)
# in relative L2, m within the bf16 tolerance and v within twice it (a
# square doubles a relative error); the weights as AdamW's step from the
# rank's weights before it by its own moments, to float32 rounding (a
# first step moves a weight by at most lr (1 + wd |p|) whatever the
# gradient, so weights held to the one-process run would hold nothing)
MESH_M_TOL = 5e-2
MESH_V_TOL = 1e-1
MESH_UPDATE_TOL = 1e-6
# the prefill and decode steps again in float32 compute (the attention
# through flash's plain version: the kernel takes bf16 only), held to the
# one-process float32 run as the CPU tests hold float32 (rtol 1e-4), per
# logit: |err| <= MESH_F32_TOL * max(1, |logit|). The bf16 run's prefill
# and decode steps are held as serve's prefill is: MODEL_TOL, or
# SDPA_SLACK x the largest gap of the one-process SDPA-bf16 run over its
# prefill and decode steps (this model's bf16 disagreement at this
# cache): a rank's row-parallel partial sums round to bf16 before they
# are summed, as the reference's partitioned XLA program rounds them
MESH_F32_TOL = 1e-4


def mesh_cells() -> dict:
    """kind -> (ShapeConfig, variant): the ES step at S1's traffic under
    ``fsdp_on`` (the data, FSDP and tensor legs all run), SV's prefill and
    a decode step on its cache of 512 + 4 under ``kv_replicate`` (the
    cache's sequence split over "model")."""
    from repro_torch.configs.base import ShapeConfig
    return {
        "train": (ShapeConfig("s1", 512, 32, "train"), "fsdp_on"),
        "prefill": (ShapeConfig("sv_prefill", SERVE_P, SERVE_B, "prefill"),
                    "kv_replicate"),
        "decode": (ShapeConfig("sv_decode", SERVE_P + TEACHER_STEPS,
                               SERVE_B, "decode"), "kv_replicate")}


def _mesh_counts(counter, peak: int, ms: float, wrappers: dict) -> dict:
    from repro_torch.distributed import collectives
    return {"flops": counter.total_flops,
            "flops_by_dtype": {str(k).replace("torch.", ""): v
                               for k, v in counter.flops.items()},
            "peak_bytes": peak,
            "collectives": {k: dict(v) for k, v in
                            counter.collectives.items() if v["count"]},
            "collective_bytes_total": counter.collective_bytes,
            "launches": {k: fn.launches for k, fn in wrappers.items()
                         if fn.launches},
            "ms": ms,
            "collective_ms": 1e3 * sum(collectives.SECONDS.values()),
            "staged_bytes": sum(collectives.STAGED.values())}


@contextlib.contextmanager
def mesh_counted(wrappers: dict, out: dict):
    """One measured call: every launch count 0 just before, the peak
    reset; the cost counter's reading, the peak, the host ms (to a
    device sync) and the collectives' host ms into ``out``."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.cost import CostCounter
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    collectives.SECONDS.clear()
    collectives.STAGED.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CostCounter() as counter:
        yield
    torch.cuda.synchronize()
    out.update(_mesh_counts(counter, torch.cuda.max_memory_allocated(),
                            (time.perf_counter() - t0) * 1e3, wrappers))


def _join_mesh(rank: int, port: int):
    """Join the four ranks' gloo group over rank 0's ``TCPStore`` (a free
    localhost port) -> the (2, 2) mesh."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 4, rank == 0,
                          timeout=datetime.timedelta(seconds=600))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=4)
    return make_mesh(MESH_SHAPE, MESH_NAMES)


# how long a rank of phase mesh waits for phase mesh_moe's references
MESH_GO_S = 900


def mesh_child(rank: int, port: int, ref_dir: str) -> None:
    """``--mesh-child RANK PORT DIR``: one rank of phase ``mesh``
    (``_mesh_dense_rank``), kept for phases ``mesh_moe`` and ``mesh_ssm``
    (the four processes start once for the three): once the parent has
    written a phase's references and its go file (``DIR/go``, then
    ``DIR/go_ssm``), the rank runs its part (``_mesh_moe_rank``,
    ``_mesh_ssm_rank``); ``DIR/stop``, or MESH_GO_S seconds without
    one, ends it."""
    import torch.distributed as dist
    mesh = _join_mesh(rank, port)
    emit(_mesh_dense_rank(rank, mesh, ref_dir))
    d = Path(ref_dir)
    for go, part in (("go", _mesh_moe_rank), ("go_ssm", _mesh_ssm_rank)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        while not ((d / go).exists() or (d / "stop").exists()
                   or time.perf_counter() - t0 > MESH_GO_S):
            time.sleep(0.1)
        if not (d / go).exists():
            break
        emit(part(rank, mesh, ref_dir))
    dist.destroy_process_group()


def _mesh_dense_rank(rank: int, mesh, ref_dir: str) -> dict:
    """One rank of phase ``mesh``: its shards of the parent's weights and
    rows of its batch (the same seeds); the ES step, the prefill and four
    decode steps -> counts, times and errors against the parent's
    one-process run (``DIR/one.pt``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.launch import dryrun
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.transformer import (init_lm, lm_per_sample_loss,
                                                param_axes, tree_leaves,
                                                tree_map)
    one = torch.load(Path(ref_dir) / "one.pt", mmap=True)
    import dataclasses
    wrappers = {**_wrappers(), **_xent_halves()}
    base = get_config("qwen1.5-0.5b")
    res = {"mesh_child": rank, "coordinate": mesh.get_coordinate()}

    def shards(cfg, ctx):
        full = init_lm(base, _gen(dryrun.SEED), "cuda")   # prepare's draws
        local = tree_map(lambda t: t.contiguous().clone(),
                         shard_tree(full, param_axes(cfg), ctx))
        del full
        torch.cuda.empty_cache()
        return local

    # the ES step (fsdp_on)
    shape, variant = mesh_cells()["train"]
    cfg = dryrun.apply_variant(base, dryrun.VARIANTS[variant])[0]
    ctx = make_ctx(cfg, mesh, "train")
    lo, n = ctx.local("batch", shape.global_batch)
    batch = {k: v[lo:lo + n].clone() for k, v in dryrun.make_batch(
        base, shape.global_batch, shape.seq_len, "cuda",
        _gen(dryrun.SEED)).items()}
    prep = dryrun.prepare(base, shape, dryrun.VARIANTS[variant], "cuda",
                          minibatch=MESH_MB, mesh=mesh,
                          params=shards(cfg, ctx), batch=batch)
    params, opt = prep.args[0], prep.args[1]
    with torch.no_grad():      # the scoring losses (and a warm-up)
        losses = ctx.all_gather(lm_per_sample_loss(
            cfg, params, batch, scoring=True, ctx=ctx)[0], "batch", 0)
    train = {"loss_err": (losses - one["losses"].cuda()).abs().max().item()}
    p0 = [t.float().cpu() for t in tree_leaves(params)]   # off the card
    with mesh_counted(wrappers, train):
        metrics = prep.step()[1]
    train["selected_equal"] = bool(torch.equal(
        metrics["selected"].cpu(), one["selected"]))
    axes = param_axes(cfg)
    for f in ("m", "v"):
        num = den = 0.0
        for a, w in zip(tree_leaves(getattr(opt, f)), tree_leaves(
                shard_tree(one[f], axes, ctx))):
            num += (a.cpu().float() - w).square().sum().item()
            den += w.square().sum().item()
        train[f"{f}_rel_l2"] = (num / den) ** 0.5
    train["update_err"] = max(
        (p1.cpu() - w).abs().max().item() for p1, w in zip(
            tree_leaves(params), adamw_first_step(
                p0, [t.cpu() for t in tree_leaves(opt.m)],
                [t.cpu() for t in tree_leaves(opt.v)],
                float(metrics["lr_scale"]))))
    res["train"] = train
    del prep, params, opt, metrics, batch, losses, p0
    torch.cuda.empty_cache()

    # prefill and four decode steps (kv_replicate: the cache's sequence
    # over "model"), measured: the prefill and the first decode step
    shape, variant = mesh_cells()["decode"]
    cfg = dryrun.apply_variant(base, dryrun.VARIANTS[variant])[0]
    dctx = make_ctx(cfg, mesh, "decode")
    params = shards(cfg, dctx)
    lo, n = dctx.local("batch", SERVE_B)
    tokens = one["prompts"][lo:lo + n].cuda()
    cache = init_cache(cfg, SERVE_B, shape.seq_len, device="cuda", ctx=dctx)
    res["cache_shape"] = list(cache["kv"]["k"].shape)
    res["prefill"], res["decode"] = {}, {}
    with torch.no_grad():
        with mesh_counted(wrappers, res["prefill"]):
            logits, cache = prefill(cfg, params, {"tokens": tokens}, cache,
                                    dctx)
        errs = [logit_errs(logits, one["logits"][0, lo:lo + n].cuda())]
        pos = torch.full((1,), SERVE_P, dtype=torch.long, device="cuda")
        for i in range(TEACHER_STEPS):
            tok = one["tokens"][i, lo:lo + n, None].cuda()
            if i == 0:
                with mesh_counted(wrappers, res["decode"]):
                    logits, cache = decode_step(cfg, params, tok, cache,
                                                pos, dctx)
            else:
                logits, cache = decode_step(cfg, params, tok, cache, pos,
                                            dctx)
            errs.append(logit_errs(logits,
                                   one["logits"][i + 1, lo:lo + n].cuda()))
            pos += 1
    res["logit_errs"] = errs
    del cache, logits
    # the same in float32 compute, the attention through flash's plain
    # version, against the one-process float32 run
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cache = init_cache(f32, SERVE_B, shape.seq_len, dtype=torch.float32,
                       device="cuda", ctx=dctx)
    with torch.no_grad(), plain_attention():
        logits, cache = prefill(f32, params, {"tokens": tokens}, cache,
                                dctx)
        errs = [logit_errs(logits, one["logits_f32"][0, lo:lo + n].cuda())]
        pos = torch.full((1,), SERVE_P, dtype=torch.long, device="cuda")
        for i in range(TEACHER_STEPS):
            tok = one["tokens"][i, lo:lo + n, None].cuda()
            logits, cache = decode_step(f32, params, tok, cache, pos, dctx)
            errs.append(logit_errs(
                logits, one["logits_f32"][i + 1, lo:lo + n].cuda()))
            pos += 1
    res["logit_errs_f32"] = errs
    return res


def adamw_first_step(p0: list, m: list, v: list, lr_scale: float) -> list:
    """The weights after AdamW's first step (``dryrun.OptConfig``, the
    port's order of operations) from the weights before it and the moments
    it left: what a rank's updated weights must equal."""
    import numpy as np
    from repro_torch.launch import dryrun
    cfg = dryrun.OptConfig()
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    bc1 = float(np.float32(1.0) - np.float32(cfg.beta1))
    bc2 = float(np.float32(1.0) - np.float32(cfg.beta2))
    return [p - lr * ((a / bc1) / (torch.sqrt(b / bc2) + cfg.eps)
                      + cfg.weight_decay * p)
            for p, a, b in zip(p0, m, v)]


def _xent_halves() -> dict:
    from repro_torch.kernels.xent.ops import xent_combine, xent_partials
    return {"xent_partials": xent_partials, "xent_combine": xent_combine}


def _mesh_one_process(ref_dir: Path) -> dict:
    """The parent's one-process run on the card, saved for the ranks:
    the ES step (fsdp_on, which one card ignores) with its scoring
    losses, selected rows, updated weights and first moments; the plain
    prefill (flash's plain version) and four decode steps, teacher-forced
    with its argmax tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.transformer import (init_lm, lm_per_sample_loss,
                                                tree_map)
    base = get_config("qwen1.5-0.5b")
    shape, variant = mesh_cells()["train"]
    prep = dryrun.prepare(base, shape, dryrun.VARIANTS[variant], "cuda",
                          minibatch=MESH_MB)
    params, opt, batch = prep.args[0], prep.args[1], prep.args[-1]
    with torch.no_grad():
        losses, _ = lm_per_sample_loss(base, params, batch, scoring=True)
    t0 = time.perf_counter()
    _, metrics = prep.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    one = {"losses": losses.cpu(), "selected": metrics["selected"].cpu(),
           "m": tree_map(lambda t: t.float().cpu(), opt.m),
           "v": tree_map(lambda t: t.float().cpu(), opt.v)}
    del prep, params, opt, batch, metrics, losses
    torch.cuda.empty_cache()
    shape, variant = mesh_cells()["decode"]
    cfg = dryrun.apply_variant(base, dryrun.VARIANTS[variant])[0]
    params = init_lm(base, _gen(dryrun.SEED), "cuda")
    prompts = dryrun.make_batch(base, SERVE_B, SERVE_P, "cuda",
                                _gen(dryrun.SEED + 1), train=False)["tokens"]

    def run(c, attention, toks, dtype=torch.bfloat16):
        """Prefill and TEACHER_STEPS decode steps, teacher-forced with
        ``toks`` (or the run's own argmax) -> (logits (steps + 1, B, V),
        the tokens fed)."""
        cache = init_cache(c, SERVE_B, shape.seq_len, dtype=dtype,
                           device="cuda")
        with torch.no_grad(), attention():
            logits, cache = prefill(c, params, {"tokens": prompts}, cache)
            seq, fed = [logits], []
            pos = torch.full((1,), SERVE_P, dtype=torch.long, device="cuda")
            for i in range(TEACHER_STEPS):
                tok = toks[i] if toks is not None else torch.argmax(
                    seq[-1], dim=-1).to(torch.int32)
                fed.append(tok)
                logits, cache = decode_step(c, params, tok[:, None], cache,
                                            pos)
                seq.append(logits)
                pos += 1
        return torch.stack(seq), torch.stack(fed)
    plain, toks = run(cfg, plain_attention, None)
    sdpa, _ = run(cfg, sdpa_attention, toks)
    f32, _ = run(dataclasses.replace(cfg, compute_dtype="float32"),
                 plain_attention, toks, torch.float32)
    sdpa_gap = [logit_errs(a, b) for a, b in zip(sdpa, plain)]
    one.update(prompts=prompts.cpu(), logits=plain.cpu(), tokens=toks.cpu(),
               logits_f32=f32.cpu())
    torch.save(one, ref_dir / "one.pt")
    del params, plain, sdpa, f32
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "sdpa_gap": sdpa_gap}


def phase_mesh(keep: Optional[dict] = None) -> dict:
    """The dense family sharded over a (2, 2) ("data", "model") mesh of
    four processes on the one card (gloo; their collectives staged
    through pinned host buffers): full-width qwen1.5-0.5b's ES step at
    S1's traffic under ``fsdp_on``, SV's prefill and four decode steps
    under ``kv_replicate``. Each rank is held to this process's
    one-process run (selected rows equal; scoring losses within 5e-2; the
    first and second moments within ``MESH_M_TOL`` and ``MESH_V_TOL`` in
    L2, the updated weights AdamW's step by them within
    ``MESH_UPDATE_TOL``; the bf16 prefill's and decode steps' logits
    within MODEL_TOL x max(1, |logit|) of the plain run's, or SDPA_SLACK x
    its SDPA-bf16 run's largest gap; float32 reruns within
    ``MESH_F32_TOL``), and each
    measured call to the dry run's trace of the same (2, 2) cell under a
    fake group of 4 in this process (FLOPs equal, peak within 5 % or 256
    MiB, collective bytes equal) and to its launches (flash 24 a scoring
    forward and a prefill, xent's two halves, one score update). With
    ``keep`` (a dict) the four processes are left in ``keep["ranks"]``,
    waiting for phase ``mesh_moe``'s work; else they are stopped. Returns
    the ranks' launches of the measured calls."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info
    base = get_config("qwen1.5-0.5b")
    pred = {}
    t0 = time.perf_counter()
    with dryrun.fake_mesh(MESH_SHAPE, MESH_NAMES) as m:
        for kind, (shape, variant) in mesh_cells().items():
            pred[kind] = dryrun.count(dryrun.prepare(
                base, shape, dryrun.VARIANTS[variant],
                minibatch=MESH_MB if kind == "train" else None, mesh=m),
                mesh_info(m))
    trace_s = time.perf_counter() - t0
    ref_dir = Path(tempfile.mkdtemp())
    ranks = None
    try:
        one = _mesh_one_process(ref_dir)
        t1 = time.perf_counter()
        ranks = MeshRanks("--mesh-child", ref_dir)
        got = ranks.wait_for("mesh_child")
        ranks_s = time.perf_counter() - t1
        (ref_dir / "one.pt").unlink()
    except BaseException:
        if ranks is not None:
            ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
        raise
    try:
        launches = _mesh_checks(got, one, pred, trace_s, ranks_s)
    except BaseException:
        ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
        raise
    if keep is None:
        ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
    else:                # the ranks wait for phase mesh_moe's references
        keep["ranks"] = ranks
    return launches


def _mesh_checks(got: list, one: dict, pred: dict, trace_s: float,
                 ranks_s: float) -> dict:
    """Phase ``mesh``'s record and checks of its ranks' answers -> their
    launches."""
    bf16_bound = SDPA_SLACK * max(rel for _, rel in one["sdpa_gap"])
    want_launches = {"train": {"gqa_flash_attention": 24,
                               "xent_partials": 1, "xent_combine": 1,
                               "fused_score_update": 1},
                     "prefill": {"gqa_flash_attention": 24},
                     "decode": {}}
    emit({"phase": "mesh", "mesh": list(MESH_SHAPE), "trace_s": trace_s,
          "ranks_s": ranks_s, "one_process_step_ms": one["step_ms"],
          "bounds": {"loss": MODEL_TOL, "m_rel_l2": MESH_M_TOL,
                     "v_rel_l2": MESH_V_TOL, "update": MESH_UPDATE_TOL,
                     "logits_bf16": max(MODEL_TOL, bf16_bound),
                     "logits_f32": f"{MESH_F32_TOL} x max(1, |logit|)",
                     "peak": list(PEAK_SLACK)},
          "one_process_sdpa_gap": one["sdpa_gap"],
          "predicted": {k: {f: v[f] for f in (
              "flops", "flops_by_dtype", "collectives",
              "collective_bytes_total", "memory", "roofline")}
              for k, v in pred.items()},
          "ranks": got, "card": smi_line()})
    launches = {"gqa_flash_attention": 0, "fused_xent": 0,
                "fused_score_update": 0}
    for r, g in enumerate(got):
        t = g["train"]
        if not t["selected_equal"]:
            raise AssertionError(f"mesh: rank {r} selected other rows")
        if t["loss_err"] > MODEL_TOL:
            raise AssertionError(f"mesh: rank {r} scoring losses off by "
                                 f"{t['loss_err']}")
        if t["m_rel_l2"] > MESH_M_TOL or t["v_rel_l2"] > MESH_V_TOL:
            raise AssertionError(f"mesh: rank {r} moments off: m by "
                                 f"{t['m_rel_l2']}, v by {t['v_rel_l2']}")
        if not t["update_err"] <= MESH_UPDATE_TOL:
            raise AssertionError(f"mesh: rank {r} weights off AdamW's step "
                                 f"by {t['update_err']}")
        for i, (_, rel) in enumerate(g["logit_errs"]):
            if rel > max(MODEL_TOL, bf16_bound):
                raise AssertionError(f"mesh: rank {r} bf16 logits of step "
                                     f"{i} off by {rel} relative (bound "
                                     f"{max(MODEL_TOL, bf16_bound)})")
        for e, rel in g["logit_errs_f32"]:
            if rel > MESH_F32_TOL:
                raise AssertionError(f"mesh: rank {r} float32 logits off "
                                     f"by {e} ({rel} relative)")
        for kind in ("train", "prefill", "decode"):
            meas, p = g[kind], pred[kind]
            if meas["flops"] != p["flops"] or \
                    meas["flops_by_dtype"] != p["flops_by_dtype"]:
                raise AssertionError(f"mesh: rank {r} {kind} counts "
                                     f"{meas['flops']} FLOPs, the trace "
                                     f"{p['flops']}")
            want_peak = p["memory"]["peak_bytes"]
            slack = max(PEAK_SLACK[0] * want_peak, PEAK_SLACK[1])
            if abs(meas["peak_bytes"] - want_peak) > slack:
                raise AssertionError(f"mesh: rank {r} {kind} peak "
                                     f"{meas['peak_bytes']} B against "
                                     f"{want_peak} B predicted")
            if meas["collectives"] != p["collectives"]:
                raise AssertionError(f"mesh: rank {r} {kind} collectives "
                                     f"{meas['collectives']}, the trace "
                                     f"{p['collectives']}")
            if meas["launches"] != want_launches[kind]:
                raise AssertionError(f"mesh: rank {r} {kind} launches "
                                     f"{meas['launches']}, expected "
                                     f"{want_launches[kind]}")
            launches["gqa_flash_attention"] += meas["launches"].get(
                "gqa_flash_attention", 0)
            launches["fused_xent"] += meas["launches"].get("xent_partials",
                                                           0)
            launches["fused_score_update"] += meas["launches"].get(
                "fused_score_update", 0)
    return launches


# ---------------------------------------------------------------------------
# phase mesh_moe: the MoE family sharded over a (2, 2) mesh of four processes
# ---------------------------------------------------------------------------

MOE_B, MOE_S, MOE_MB = 32, 512, 8     # S1's traffic: meta-batch, S, minibatch
# the one-process references route as the (2, 2) mesh does: its 2 data ranks
MOE_DP = 2


def moe_full_cfgs() -> dict:
    """name -> config: grok-1 and arctic at their published widths, depth
    cut to one layer (64 -> 1, 35 -> 1), ``fsdp_params`` off, KV heads
    replicated (both configs' ``shard_kv_heads`` off), grouped dispatch
    (``moe_groups`` 0): grok-1 under ``moe_tp_bf16`` (the experts' d_ff
    over "model", bf16 weights), arctic its own (its 128 experts over
    "model", bf16 weights, the dense residual)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    grok = dryrun.apply_variant(get_config("grok-1-314b"),
                                dryrun.VARIANTS["moe_tp_bf16"])[0]
    return {name: dataclasses.replace(c, num_layers=1, fsdp_params=False)
            for name, c in (("grok", grok),
                            ("arctic", get_config("arctic-480b")))}


def moe_smoke_cases() -> dict:
    """name -> (smoke config, variant): the whole ES step at S1's traffic,
    which four ranks of the full widths cannot hold on one card: grok
    smoke (TP) under grouped and global dispatch (the capacity split over
    "data"), arctic smoke (EP, global dispatch, the dense residual)."""
    from repro_torch.configs.registry import get_smoke_config
    grok = get_smoke_config("grok-1-314b")
    return {"grok_smoke_grouped": (grok, "moe_grouped"),
            "grok_smoke_ungrouped": (grok, "es_ungrouped"),
            "arctic_smoke": (get_smoke_config("arctic-480b"), "es")}


@contextlib.contextmanager
def mesh_groups(dp: int):
    """The port's one-process MoE calls group their tokens as a mesh of
    ``dp`` data ranks does (``moe._auto_groups`` on the global token
    count), so that they route as the mesh's ranks; calls on a mesh are
    untouched."""
    from repro_torch.models import moe
    real = moe._auto_groups

    def groups(ctx, T, E):
        if ctx.mesh is not None:
            return real(ctx, T, E)
        g = dp
        if T % g:
            return 1
        while g > 1 and T // g < 2 * E:
            g //= 2
        return g
    moe._auto_groups = groups
    try:
        yield
    finally:
        moe._auto_groups = real


def moe_weights(cfg, ctx, seed: int) -> dict:
    """``cfg``'s parameters (N(0, 0.02^2) weights, unit norm scales, in
    its ``param_dtype``): this rank's shards under ``ctx``, whole without
    a mesh. Each leaf is drawn from a generator seeded by its name, an
    expert stack expert by expert by its name and the expert's index, so
    the ranks and the one-process run hold the same values and no rank
    ever draws a whole stack (arctic's is 26.8 GB in bf16)."""
    import zlib

    from repro_torch.models.layers import LeafSpecs, local_shape
    from repro_torch.models.transformer import (_init_tree, dtype_of,
                                                param_axes)
    pdt = dtype_of(cfg.param_dtype)

    def draw(shape, name, scale):
        g = _gen((seed * 1_000_003 + zlib.crc32(name.encode())) % 2 ** 63)
        return torch.randn(shape, device="cuda", generator=g).mul_(scale)

    def cut(t, axes):
        for dim, a in enumerate(axes):
            lo, n = ctx.local(a, t.shape[dim])
            t = t.narrow(dim, lo, n)
        return t.to(pdt)

    def make(path, spec, axes):
        if spec.kind == "full":
            return cut(torch.full(spec.shape, spec.arg, device="cuda"), axes)
        if "expert" not in axes:
            return cut(draw(spec.shape, path, spec.arg), axes).contiguous()
        i = axes.index("expert")
        lo, n = ctx.local("expert", spec.shape[i])
        rest = axes[:i] + axes[i + 1:]
        one = spec.shape[:i] + spec.shape[i + 1:]
        out = torch.empty(local_shape(spec.shape, axes, ctx), dtype=pdt,
                          device="cuda")
        for e in range(lo, lo + n):
            out.select(i, e - lo).copy_(cut(draw(one, f"{path}/{e}",
                                                 spec.arg), rest))
        return out

    def walk(tree, axes, path):
        if isinstance(tree, dict):
            return {k: walk(v, axes[k], f"{path}/{k}")
                    for k, v in tree.items()}
        return make(path, tree, axes)
    return walk(_init_tree(cfg, LeafSpecs()), param_axes(cfg), "")


def _routes_bad(got: list, want: list, coord: int) -> list:
    """Calls whose expert ids or kept pairs differ from the one-process
    record's groups of this rank."""
    if len(got) != len(want):
        return [f"{len(got)} MoE calls against {len(want)}"]
    bad = []
    for i, ((e, k, _), (we, wk, _)) in enumerate(zip(got, want)):
        we, wk = (_own_groups(t, e.shape[0], coord) for t in (we, wk))
        if e.shape != we.shape or not torch.equal(e, we):
            bad.append(f"expert ids {i}")
        if k.shape != wk.shape or not torch.equal(k, wk):
            bad.append(f"kept {i}")
    return bad


@contextlib.contextmanager
def sdpa_everywhere():
    """``sdpa_attention``, and a decode step's attention
    (``attention._grouped_attn``, plain PyTorch: bf16 scores, a float32
    softmax) through one bf16 ``scaled_dot_product_attention`` call too: a
    second bf16 attention on every step of a teacher-forced serve, not only
    its prefill (a one-layer model's decode steps read the same cache in
    both runs, so only their attention can differ)."""
    import torch.nn.functional as F
    from repro_torch.models import attention
    plain = attention._grouped_attn

    def sdpa(q, k, v, mask):
        B, S, K, G, hd = q.shape
        m = None if mask is None else (mask if mask.ndim == 2
                                       else mask[:, None]).to(q.dtype)
        out = F.scaled_dot_product_attention(
            q.reshape(B, S, K * G, hd).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), attn_mask=m, enable_gqa=True)
        return out.transpose(1, 2).reshape(B, S, K, G, hd)
    attention._grouped_attn = sdpa
    try:
        with sdpa_attention():
            yield
    finally:
        attention._grouped_attn = plain


def _serve_teacher(cfg, params, prompts, cache, ctx, tokens, want=None,
                   attention=contextlib.nullcontext, counted=None):
    """The prefill of ``prompts`` and TEACHER_STEPS decode steps fed
    ``tokens`` (the one-process run's; None: the run's own argmax) under
    ``attention``; ``counted`` (wrappers, outs) measures the prefill and
    the first decode step (``mesh_counted``). A step cut by ``Routed``
    gives no logits. -> (logits a step, tokens fed, errors against
    ``want`` (steps + 1, B, V))."""
    from repro_torch.models.model import decode_step, prefill
    seq, fed, errs = [], [], []
    with attention():
        for i in range(TEACHER_STEPS + 1):
            if i and tokens is None:
                tok = torch.argmax(seq[-1], dim=-1).to(torch.int32)
            elif i:
                tok = tokens[i - 1].cuda()
            meter = (mesh_counted(counted[0], counted[1][i])
                     if counted and i < 2 else contextlib.nullcontext())
            try:
                with meter:
                    if i == 0:
                        logits, cache = prefill(cfg, params,
                                                {"tokens": prompts}, cache,
                                                ctx)
                    else:
                        fed.append(tok)
                        pos = torch.full((1,), SERVE_P + i - 1,
                                         dtype=torch.long, device="cuda")
                        logits, cache = decode_step(cfg, params, tok[:, None],
                                                    cache, pos, ctx)
            except Routed:
                continue
            seq.append(logits)
            if want is not None:
                errs.append(logit_errs(logits, want[i].cuda()))
    return seq, fed, errs


def _moe_prepared(cfg, kind: str, mesh):
    """A full-width measured call as the dry run traces it on ``meta`` on
    a mesh (rank 0's program): the scoring forward at S1's traffic, SV's
    prefill or a decode step on its cache of 512 + 4 (the decode rules
    for both, as the ranks run them)."""
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch import dryrun
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.transformer import init_lm, lm_per_sample_loss
    ctx = make_ctx(cfg, mesh, "train" if kind == "score" else "decode")
    params = init_lm(cfg, None, "meta", ctx)
    if kind == "score":
        batch = dryrun.make_batch(cfg, ctx.local("batch", MOE_B)[1], MOE_S,
                                  "meta", None)

        def score():
            with torch.no_grad():
                return lm_per_sample_loss(cfg, params, batch, scoring=True,
                                          ctx=ctx)
        return dryrun.Prepared(score, (params, batch), MOE_B * MOE_S, 0)
    n = ctx.local("batch", SERVE_B)[1]
    cache = init_cache(cfg, SERVE_B, SERVE_P + TEACHER_STEPS, device="meta",
                       ctx=ctx)
    if kind == "prefill":
        batch = dryrun.make_batch(cfg, n, SERVE_P, "meta", None, train=False)
        return dryrun.Prepared(lambda: prefill(cfg, params, batch, cache, ctx),
                               (params, batch, cache), SERVE_B * SERVE_P, 0)
    tok = dryrun.make_batch(cfg, n, 1, "meta", None, train=False)["tokens"]
    pos = torch.full((1,), SERVE_P, dtype=torch.long, device="meta")
    return dryrun.Prepared(
        lambda: decode_step(cfg, params, tok, cache, pos, ctx),
        (params, tok, cache, pos), SERVE_B, 0)


def _moe_full_one_process(cfg, f32_logits: bool) -> dict:
    """The parent's one-process run of a full-width model on the card,
    routed as the mesh's ranks group their tokens (``mesh_groups``): the
    scoring forward (kernels) at S1's traffic, its losses and routes; the
    plain prefill (flash's plain version) and four decode steps fed its
    argmax, their logits and routes; the same with every attention through
    SDPA in bf16 (``sdpa_everywhere``) on those routes (each step's gap,
    the bf16 bound); and a float32 rerun on the plain run's
    tokens, its routes (and its logits when ``f32_logits``; else cut after
    each routing: a float32 copy of arctic's expert stacks is 53.5 GB)."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import init_cache
    from repro_torch.models.transformer import lm_per_sample_loss
    params = moe_weights(cfg, ShardCtx(), dryrun.SEED)
    one = {}
    with torch.no_grad(), mesh_groups(MOE_DP):
        batch = dryrun.make_batch(cfg, MOE_B, MOE_S, "cuda",
                                  _gen(dryrun.SEED))
        rec = []
        with dispatch_spy(rec):
            one["losses"] = lm_per_sample_loss(
                cfg, params, batch, scoring=True)[0].float().cpu()
        one["score_routes"] = rec
        del batch
        prompts = dryrun.make_batch(cfg, SERVE_B, SERVE_P, "cuda",
                                    _gen(dryrun.SEED + 1),
                                    train=False)["tokens"]

        def serve(c, attention, tokens, dtype=torch.bfloat16, replay=None,
                  stop=False):
            rec = []
            cache = init_cache(c, SERVE_B, SERVE_P + TEACHER_STEPS,
                               dtype=dtype, device="cuda")
            with dispatch_spy(rec, replay, stop=stop):
                seq, fed, _ = _serve_teacher(c, params, prompts, cache,
                                             ShardCtx(), tokens,
                                             attention=attention)
            return seq, fed, rec
        plain, fed, one["routes"] = serve(cfg, plain_attention, None)
        fed = torch.stack(fed).cpu()
        sdpa, _, _ = serve(cfg, sdpa_everywhere, fed, replay=one["routes"])
        one["sdpa_gap"] = [logit_errs(a, b) for a, b in zip(sdpa, plain)]
        f32, _, one["routes_f32"] = serve(
            dataclasses.replace(cfg, compute_dtype="float32"),
            plain_attention, fed, torch.float32, stop=not f32_logits)
    one.update(prompts=prompts.cpu(), tokens=fed,
               logits=torch.stack(plain).float().cpu(),
               logits_f32=(torch.stack(f32).cpu() if f32_logits else None))
    del params, plain, sdpa, f32
    torch.cuda.empty_cache()
    return one


def _moe_smoke_one_process(base, variant: str) -> dict:
    """The parent's one-process ES step of a smoke case (routed as the
    mesh's ranks group their tokens): its scoring losses, selected rows,
    moments and routes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import lm_per_sample_loss, tree_map
    cfg = dryrun.apply_variant(base, dryrun.VARIANTS[variant])[0]
    with mesh_groups(MOE_DP):
        prep = dryrun.prepare(base, ShapeConfig("s1", MOE_S, MOE_B, "train"),
                              dryrun.VARIANTS[variant], "cuda",
                              minibatch=MOE_MB)
        params, opt, batch = prep.args[0], prep.args[1], prep.args[-1]
        with torch.no_grad():
            losses = lm_per_sample_loss(cfg, params, batch, scoring=True)[0]
        rec = []
        with dispatch_spy(rec):
            metrics = prep.step()[1]
    return {"losses": losses.float().cpu(),
            "selected": metrics["selected"].cpu(), "routes": rec,
            "m": tree_map(lambda t: t.float().cpu(), opt.m),
            "v": tree_map(lambda t: t.float().cpu(), opt.v)}


def _moe_full_rank(cfg, mesh, one: dict, wrappers: dict,
                   f32_logits: bool) -> dict:
    """A rank's full-width calls on the one-process run's routes: the
    scoring forward, the prefill and four decode steps (bf16, measured:
    the scoring forward, the prefill and the first decode step), then the
    float32 rerun of the prefill and decode steps on their own routes."""
    import dataclasses

    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_cache
    from repro_torch.models.transformer import lm_per_sample_loss
    ctx = make_ctx(cfg, mesh, "train")
    dctx = make_ctx(cfg, mesh, "decode")
    c = ctx.coord("batch")
    params = moe_weights(cfg, ctx, dryrun.SEED)
    lo, n = ctx.local("batch", MOE_B)
    batch = {k: v[lo:lo + n].clone() for k, v in dryrun.make_batch(
        cfg, MOE_B, MOE_S, "cuda", _gen(dryrun.SEED)).items()}
    res = {"score": {}, "prefill": {}, "decode": {}}
    rec = []
    with torch.no_grad():
        with dispatch_spy(rec, one["score_routes"], c), \
                mesh_counted(wrappers, res["score"]):
            losses = lm_per_sample_loss(cfg, params, batch, scoring=True,
                                        ctx=ctx)[0]
        losses = ctx.all_gather(losses, "batch", 0)
    res["score"]["loss_err"] = (losses.float().cpu()
                                - one["losses"]).abs().max().item()
    res["score"]["flips"] = sum(f for *_, f in rec)
    res["score"]["routes_bad"] = _routes_bad(rec, one["score_routes"], c)
    del batch, losses
    lo, n = dctx.local("batch", SERVE_B)
    prompts = one["prompts"][lo:lo + n].cuda()
    tokens = one["tokens"][:, lo:lo + n]
    cache = init_cache(cfg, SERVE_B, SERVE_P + TEACHER_STEPS, device="cuda",
                       ctx=dctx)
    res["cache_shape"] = list(cache["kv"]["k"].shape)
    rec = []
    with torch.no_grad(), dispatch_spy(rec, one["routes"], c):
        _, _, res["logit_errs"] = _serve_teacher(
            cfg, params, prompts, cache, dctx, tokens,
            one["logits"][:, lo:lo + n],
            counted=(wrappers, [res["prefill"], res["decode"]]))
    res["serve_flips"] = sum(f for *_, f in rec)
    res["serve_routes_bad"] = _routes_bad(rec, one["routes"], c)
    del cache
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cache = init_cache(f32, SERVE_B, SERVE_P + TEACHER_STEPS,
                       dtype=torch.float32, device="cuda", ctx=dctx)
    rec = []
    want = one["logits_f32"][:, lo:lo + n] if f32_logits else None
    with torch.no_grad(), dispatch_spy(rec, stop=not f32_logits):
        _, _, res["logit_errs_f32"] = _serve_teacher(
            f32, params, prompts, cache, dctx, tokens, want,
            attention=plain_attention)
    res["routes_f32_bad"] = _routes_bad(rec, one["routes_f32"], c)
    del params, cache
    torch.cuda.empty_cache()
    return res


def _moe_smoke_rank(base, variant: str, mesh, one: dict,
                    wrappers: dict) -> dict:
    """A rank's ES step of a smoke case on the one-process run's weights,
    rows and routes, held as phase ``mesh`` holds the dense step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import (init_lm, lm_per_sample_loss,
                                                param_axes, tree_leaves,
                                                tree_map)
    cfg = dryrun.apply_variant(base, dryrun.VARIANTS[variant])[0]
    ctx = make_ctx(cfg, mesh, "train")
    c = ctx.coord("batch")
    axes = param_axes(cfg)
    full = init_lm(base, _gen(dryrun.SEED), "cuda")     # prepare's draws
    params = tree_map(lambda t: t.contiguous().clone(),
                      shard_tree(full, axes, ctx))
    del full
    lo, n = ctx.local("batch", MOE_B)
    batch = {k: v[lo:lo + n].clone() for k, v in dryrun.make_batch(
        base, MOE_B, MOE_S, "cuda", _gen(dryrun.SEED)).items()}
    prep = dryrun.prepare(base, ShapeConfig("s1", MOE_S, MOE_B, "train"),
                          dryrun.VARIANTS[variant], "cuda",
                          minibatch=MOE_MB, mesh=mesh, params=params,
                          batch=batch)
    params, opt = prep.args[0], prep.args[1]
    rec = []
    with torch.no_grad(), dispatch_spy(rec, one["routes"][:cfg.num_layers],
                                       c):
        losses = ctx.all_gather(lm_per_sample_loss(
            cfg, params, batch, scoring=True, ctx=ctx)[0], "batch", 0)
    train = {"loss_err": (losses.float().cpu()
                          - one["losses"]).abs().max().item()}
    p0 = [t.float().cpu() for t in tree_leaves(params)]
    rec = []
    with dispatch_spy(rec, one["routes"], c), mesh_counted(wrappers, train):
        metrics = prep.step()[1]
    train["flips"] = sum(f for *_, f in rec)
    train["routes_bad"] = _routes_bad(rec, one["routes"], c)
    train["selected_equal"] = bool(torch.equal(metrics["selected"].cpu(),
                                               one["selected"]))
    for f in ("m", "v"):
        num = den = 0.0
        for a, w in zip(tree_leaves(getattr(opt, f)), tree_leaves(
                shard_tree(one[f], axes, ctx))):
            num += (a.cpu().float() - w).square().sum().item()
            den += w.square().sum().item()
        train[f"{f}_rel_l2"] = (num / den) ** 0.5
    train["update_err"] = max(
        (p1.cpu().float() - w).abs().max().item() for p1, w in zip(
            tree_leaves(params), adamw_first_step(
                p0, [t.cpu().float() for t in tree_leaves(opt.m)],
                [t.cpu().float() for t in tree_leaves(opt.v)],
                float(metrics["lr_scale"]))))
    return train


def mesh_moe_child(rank: int, port: int, ref_dir: str) -> None:
    """``--mesh-moe-child RANK PORT DIR``: phase ``mesh_moe``'s ranks on
    their own (when phase ``mesh`` has not started them)."""
    import torch.distributed as dist
    mesh = _join_mesh(rank, port)
    emit(_mesh_moe_rank(rank, mesh, ref_dir))
    dist.destroy_process_group()


def _mesh_moe_rank(rank: int, mesh, ref_dir: str) -> dict:
    """One rank of phase ``mesh_moe``: the full-width calls of each of
    ``moe_full_cfgs``, then the ES step of each of ``moe_smoke_cases``,
    against the parent's one-process runs (``DIR/<name>.pt``)."""
    wrappers = {**_wrappers(), **_xent_halves()}
    res = {"mesh_moe_child": rank, "coordinate": mesh.get_coordinate()}
    for name, cfg in moe_full_cfgs().items():
        one = torch.load(Path(ref_dir) / f"{name}.pt")
        res[name] = _moe_full_rank(cfg, mesh, one, wrappers,
                                   one["logits_f32"] is not None)
    for name, (base, variant) in moe_smoke_cases().items():
        res[name] = _moe_smoke_rank(base, variant, mesh,
                                    torch.load(Path(ref_dir) / f"{name}.pt"),
                                    wrappers)
    return res


class MeshRanks:
    """Four ``chip_smoke.py FLAG RANK PORT DIR`` processes sharing the
    card (rank 0's store on a free localhost port), each one's output read
    by a thread of its own: a rank blocked on a full pipe would stall the
    others inside a collective."""

    def __init__(self, flag: str, ref_dir: Path):
        import socket
        import threading
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        sys.stdout.flush()
        self.dir = ref_dir
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, str(r),
             str(port), str(ref_dir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(4)]
        self.lines = [[] for _ in self.procs]
        self.readers = [threading.Thread(target=self._read, args=(r,),
                                         daemon=True) for r in range(4)]
        for t in self.readers:
            t.start()
        self.closed = False
        atexit.register(self.close)       # no rank outlives this script

    def _read(self, r: int) -> None:
        for line in self.procs[r].stdout:
            self.lines[r].append(line)

    def wait_for(self, tag: str, timeout: float = 600) -> list:
        """Each rank's last JSON line that starts with ``{"<tag>"``;
        raises when a rank ends without one, or at ``timeout``."""
        t0 = time.perf_counter()
        while True:
            got = [[json.loads(x) for x in lines
                    if x.startswith('{"' + tag + '"')]
                   for lines in self.lines]
            if all(got):
                return [g[-1] for g in got]
            for r, (p, g) in enumerate(zip(self.procs, got)):
                if not g and p.poll() is not None:
                    self.readers[r].join(5)
                    raise AssertionError(
                        f"{tag}: rank {r} failed (rc {p.returncode}):\n"
                        f"{''.join(self.lines[r])[-4000:]}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{tag}: no answer in {timeout} s")
            time.sleep(0.2)

    def close(self) -> None:
        """Tell ranks that wait for more work to stop; end them all."""
        if self.closed:
            return
        self.closed = True
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "stop").touch()
        for p in self.procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in self.readers:
            t.join(5)


def _held_to_trace(what: str, meas: dict, p: dict, launches: dict) -> None:
    """A measured call against the dry run's trace of it: FLOPs (by
    dtype) and collectives equal, the peak within PEAK_SLACK, and the
    launches ``launches``."""
    if meas["flops"] != p["flops"] or \
            meas["flops_by_dtype"] != p["flops_by_dtype"]:
        raise AssertionError(f"{what}: {meas['flops']} FLOPs, the trace "
                             f"{p['flops']}")
    want = p["memory"]["peak_bytes"]
    if abs(meas["peak_bytes"] - want) > max(PEAK_SLACK[0] * want,
                                            PEAK_SLACK[1]):
        raise AssertionError(f"{what}: peak {meas['peak_bytes']} B against "
                             f"{want} B predicted")
    if meas["collectives"] != p["collectives"]:
        raise AssertionError(f"{what}: collectives {meas['collectives']}, "
                             f"the trace {p['collectives']}")
    if meas["launches"] != launches:
        raise AssertionError(f"{what}: launches {meas['launches']}, "
                             f"expected {launches}")


def phase_mesh_moe(ranks: Optional["MeshRanks"] = None,
                   keep: Optional[dict] = None) -> dict:
    """The MoE family sharded over a (2, 2) ("data", "model") mesh of four
    processes on the one card (gloo, staged through pinned host buffers;
    ``ranks``: phase ``mesh``'s, waiting for this work, else its own).
    grok-1 (TP experts) and arctic (EP experts and its dense residual) at
    published widths, one layer each (``moe_full_cfgs``): the scoring
    forward at S1's traffic (grouped dispatch: a group a data rank), SV's
    prefill and four decode steps (a decode step's 8 tokens make one
    group spanning both data ranks). The whole ES step, which four
    full-width ranks cannot hold on one card, at the smoke configs
    (``moe_smoke_cases``). Each rank is held to this process's
    one-process run, routed as the mesh groups its tokens:
    - bf16 runs on the one-process run's routes (``dispatch_spy``
      replay): the kept pairs equal, the scoring losses within MODEL_TOL,
      each of the prefill's and decode steps' logits within max(MODEL_TOL,
      SDPA_SLACK x that step's gap in a one-process run with every
      attention through SDPA-bf16) per logit: with one layer a decode
      step's cache is the same in any two runs, so only a second bf16
      attention at the step itself measures the model's bf16
      disagreement there (a prefill-only SDPA run's decode gaps are 0);
      the tokens whose own top k would differ are counted (``flips``);
    - float32 reruns of the prefill and decode steps on their own routes:
      the expert ids and kept pairs equal the one-process float32 run's,
      and grok's logits within MESH_F32_TOL (arctic's rerun stops at each
      routing: four ranks' float32 copies of its expert stacks do not fit
      beside their bf16 ones);
    - the smoke ES steps as phase ``mesh`` holds the dense one.
    Each measured call against the dry run's trace of it under a fake
    group of 4, made first: FLOPs and collectives equal, the peak within
    5 % or 256 MiB, and its launches. With ``keep`` (a dict) phase
    ``mesh``'s processes are left in ``keep["ranks"]`` for phase
    ``mesh_ssm``. Returns the ranks' launches."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info
    t0 = time.perf_counter()
    full, smoke = moe_full_cfgs(), moe_smoke_cases()
    s1 = ShapeConfig("s1", MOE_S, MOE_B, "train")
    pred = {}
    with dryrun.fake_mesh(MESH_SHAPE, MESH_NAMES) as m:
        info = mesh_info(m)
        for name, cfg in full.items():
            pred[name] = {kind: dryrun.count(_moe_prepared(cfg, kind, m),
                                             info)
                          for kind in ("score", "prefill", "decode")}
        for name, (base, variant) in smoke.items():
            pred[name] = dryrun.count(dryrun.prepare(
                base, s1, dryrun.VARIANTS[variant], minibatch=MOE_MB,
                mesh=m), info)
    trace_s = time.perf_counter() - t0
    ref_dir = ranks.dir if ranks is not None else Path(tempfile.mkdtemp())
    try:
        t1 = time.perf_counter()
        ones = {}
        for name, cfg in full.items():
            ones[name] = _moe_full_one_process(cfg, name == "grok")
            torch.save(ones[name], ref_dir / f"{name}.pt")
        for name, (base, variant) in smoke.items():
            torch.save(_moe_smoke_one_process(base, variant),
                       ref_dir / f"{name}.pt")
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        if ranks is None:
            ranks = MeshRanks("--mesh-moe-child", ref_dir)
        else:
            (ref_dir / "go").touch()
        got = ranks.wait_for("mesh_moe_child")
        ranks_s = time.perf_counter() - t1
    except BaseException:
        if ranks is not None:
            ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
        raise
    for name in (*full, *smoke):
        (ref_dir / f"{name}.pt").unlink()
    if keep is not None and (ref_dir / "go").exists():
        keep["ranks"] = ranks    # phase mesh's: they wait for mesh_ssm
    else:
        ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
    bounds = {name: [max(MODEL_TOL, SDPA_SLACK * rel)
                     for _, rel in ones[name]["sdpa_gap"]] for name in full}
    emit({"phase": "mesh_moe", "mesh": list(MESH_SHAPE), "trace_s": trace_s,
          "one_process_s": one_s, "ranks_s": ranks_s,
          "bounds": {"loss": MODEL_TOL, "logits_bf16": bounds,
                     "logits_f32": f"{MESH_F32_TOL} x max(1, |logit|)",
                     "m_rel_l2": MESH_M_TOL, "v_rel_l2": MESH_V_TOL,
                     "update": MESH_UPDATE_TOL, "peak": list(PEAK_SLACK)},
          "one_process_sdpa_gap": {n: ones[n]["sdpa_gap"] for n in full},
          "predicted": {n: ({k: {f: v[f] for f in (
              "flops", "flops_by_dtype", "collectives",
              "collective_bytes_total", "memory", "roofline")}
              for k, v in p.items()} if n in full else {f: p[f] for f in (
                  "flops", "collectives", "collective_bytes_total",
                  "memory")}) for n, p in pred.items()},
          "ranks": got, "card": smi_line()})
    one_layer = {"score": {"gqa_flash_attention": 1, "xent_partials": 1,
                           "xent_combine": 1},
                 "prefill": {"gqa_flash_attention": 1}, "decode": {}}
    launches = {"gqa_flash_attention": 0, "fused_xent": 0,
                "fused_score_update": 0}

    def add(meas):
        launches["gqa_flash_attention"] += meas["launches"].get(
            "gqa_flash_attention", 0)
        launches["fused_xent"] += meas["launches"].get("xent_partials", 0)
        launches["fused_score_update"] += meas["launches"].get(
            "fused_score_update", 0)
    for r, g in enumerate(got):
        for name in full:
            res, where = g[name], f"mesh_moe: rank {r} {name}"
            if res["score"]["loss_err"] > MODEL_TOL:
                raise AssertionError(f"{where} scoring losses off by "
                                     f"{res['score']['loss_err']}")
            for key in ("score", ):
                if res[key]["routes_bad"]:
                    raise AssertionError(f"{where} {key} routes "
                                         f"{res[key]['routes_bad']}")
            for key in ("serve_routes_bad", "routes_f32_bad"):
                if res[key]:
                    raise AssertionError(f"{where} {key} {res[key]}")
            for i, (_, rel) in enumerate(res["logit_errs"]):
                if rel > bounds[name][i]:
                    raise AssertionError(f"{where} bf16 logits of step {i} "
                                         f"off by {rel} (bound "
                                         f"{bounds[name][i]})")
            for e, rel in res["logit_errs_f32"]:
                if rel > MESH_F32_TOL:
                    raise AssertionError(f"{where} float32 logits off by "
                                         f"{e} ({rel} relative)")
            if name == "grok" and len(res["logit_errs_f32"]) != \
                    TEACHER_STEPS + 1:
                raise AssertionError(f"{where}: float32 logits unchecked")
            for kind in ("score", "prefill", "decode"):
                _held_to_trace(f"{where} {kind}", res[kind],
                               pred[name][kind], one_layer[kind])
                add(res[kind])
        for name, (base, _) in smoke.items():
            t, where = g[name], f"mesh_moe: rank {r} {name}"
            if not t["selected_equal"]:
                raise AssertionError(f"{where} selected other rows")
            if t["routes_bad"]:
                raise AssertionError(f"{where} routes {t['routes_bad']}")
            if t["loss_err"] > MODEL_TOL:
                raise AssertionError(f"{where} scoring losses off by "
                                     f"{t['loss_err']}")
            if t["m_rel_l2"] > MESH_M_TOL or t["v_rel_l2"] > MESH_V_TOL:
                raise AssertionError(f"{where} moments off: m by "
                                     f"{t['m_rel_l2']}, v by "
                                     f"{t['v_rel_l2']}")
            if not t["update_err"] <= MESH_UPDATE_TOL:
                raise AssertionError(f"{where} weights off AdamW's step by "
                                     f"{t['update_err']}")
            _held_to_trace(where, t, pred[name], {
                "gqa_flash_attention": base.num_layers, "xent_partials": 1,
                "xent_combine": 1, "fused_score_update": 1})
            add(t)
    return launches


# ---------------------------------------------------------------------------
# phase mesh_ssm: the SSM and hybrid families over a (2, 2) mesh, and the
# checkpoint of a model-sharded state
# ---------------------------------------------------------------------------

# (arch, depth cut) at published widths: mamba2-780m 48 -> 2 Mamba2 layers;
# zamba2-2.7b 9 sites of 6 -> 1 site of 2 Mamba2 layers and the shared
# block; both keep fsdp_params (their own True)
SSM_CUTS = {"mamba2": ("mamba2-780m", {"num_layers": 2}),
            "zamba2": ("zamba2-2.7b", {"num_layers": 2,
                                       "hybrid_attn_every": 2})}
# the Mamba2 leaves whole on every rank (``models/ssm.py:REPLICATED``)
SSM_REPLICATED = ("w_bc", "w_dt", "conv_bc", "dt_bias", "A_log", "D")


def ssm_cfgs() -> dict:
    import dataclasses
    from repro_torch.configs import get_config
    return {name: dataclasses.replace(get_config(arch), **cut)
            for name, (arch, cut) in SSM_CUTS.items()}


def ssm_cells() -> dict:
    """kind -> ShapeConfig: the ES step at S1's traffic, SV's prefill and
    a decode step on its cache of 512 + 4."""
    from repro_torch.configs.base import ShapeConfig
    return {"train": ShapeConfig("s1", 512, 32, "train"),
            "prefill": ShapeConfig("sv_prefill", SERVE_P, SERVE_B,
                                   "prefill"),
            "decode": ShapeConfig("sv_decode", SERVE_P + TEACHER_STEPS,
                                  SERVE_B, "decode")}


def _ssm_one_process(cfg) -> dict:
    """The parent's one-process runs of a cut model on the card: the bf16
    ES step (kernels) at S1's traffic with its scoring losses, selected
    rows and moments, and the float32 per-sample losses of the same
    weights and batch (the plain forward, before the step); the bf16
    prefill and four decode steps fed its own argmax (flash in the
    prefill, as the ranks), and the same in float32 (flash's plain
    version) fed the same tokens."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import (init_lm, lm_per_sample_loss,
                                                tree_map)
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import init_cache
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    prep = dryrun.prepare(cfg, ssm_cells()["train"], dryrun.VARIANTS["es"],
                          "cuda", minibatch=MESH_MB)
    params, opt, batch = prep.args[0], prep.args[1], prep.args[-1]
    with torch.no_grad():
        losses = lm_per_sample_loss(cfg, params, batch, scoring=True)[0]
        losses_f32 = lm_per_sample_loss(f32, params, batch)[0]
    metrics = prep.step()[1]
    one = {"losses": losses.float().cpu(), "losses_f32": losses_f32.cpu(),
           "selected": metrics["selected"].cpu(),
           "m": tree_map(lambda t: t.float().cpu(), opt.m),
           "v": tree_map(lambda t: t.float().cpu(), opt.v)}
    del prep, params, opt, batch, metrics
    torch.cuda.empty_cache()
    params = init_lm(cfg, _gen(dryrun.SEED), "cuda")
    prompts = dryrun.make_batch(cfg, SERVE_B, SERVE_P, "cuda",
                                _gen(dryrun.SEED + 1), train=False)["tokens"]
    with torch.no_grad():
        cache = init_cache(cfg, SERVE_B, SERVE_P + TEACHER_STEPS,
                           device="cuda")
        bf16, fed, _ = _serve_teacher(cfg, params, prompts, cache,
                                      ShardCtx(), None)
        fed = torch.stack(fed).cpu()
        cache = init_cache(f32, SERVE_B, SERVE_P + TEACHER_STEPS,
                           dtype=torch.float32, device="cuda")
        f32_seq, _, _ = _serve_teacher(f32, params, prompts, cache,
                                       ShardCtx(), fed,
                                       attention=plain_attention)
    one.update(prompts=prompts.cpu(), tokens=fed,
               logits=torch.stack(bf16).float().cpu(),
               logits_f32=torch.stack(f32_seq).cpu())
    del params, cache, bf16, f32_seq
    torch.cuda.empty_cache()
    return one


def _rel_l2(got: dict, want: dict, axes: dict, ctx) -> float:
    """The relative L2 distance of a rank's tree of moments to the
    one-process tree cut to its shards."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.transformer import tree_leaves
    num = den = 0.0
    for a, w in zip(tree_leaves(got),
                    tree_leaves(shard_tree(want, axes, ctx))):
        num += (a.cpu().float() - w).square().sum().item()
        den += w.square().sum().item()
    return (num / den) ** 0.5


def _f32_errs(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |err| / max(1, |want|) of two float32 tensors."""
    return logit_errs(got.float().cpu(), want)[1]


def _ckpt_round_trip(eng, st, ckpt_dir: Path) -> dict:
    """The rank's ES state saved with its layout from the four ranks
    (each split leaf gathered whole, process 0 writes), restored onto the
    same ranks (bitwise the rank's tree) and onto one process on the card
    (each rank's own restore with no layout: its shard of every whole
    leaf bitwise the rank's own); a save without the layout refused ->
    {"refused", "same_grid", "one_process", seconds}."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten
    tree = eng.state_dict(st)
    layout = eng.checkpoint_layout()
    ck = Checkpointer(ckpt_dir)
    out = {}
    try:
        ck.save(tree, 1)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    t0 = time.perf_counter()
    ck.save(tree, 1, layout=layout)
    dist.barrier()
    out["save_s"] = time.perf_counter() - t0
    flat, split, ctx = flatten(tree), layout.split, layout.ctx
    t0 = time.perf_counter()
    back = flatten(ck.restore(tree, 1, layout=layout))
    out["restore_s"] = time.perf_counter() - t0
    out["same_grid"] = [k for k, v in flat.items()
                        if not torch.equal(back[k], v)]
    del back
    # one process: a template of whole leaves, no layout
    template = {k: torch.empty(
        [n * ctx.size(a) for n, a in zip(v.shape, split[k])]
        if k in split else v.shape, dtype=v.dtype, device=v.device)
        for k, v in flat.items()}
    t0 = time.perf_counter()
    one = flatten(ck.restore(template, 1))
    out["restore_one_s"] = time.perf_counter() - t0
    del template
    out["one_process"] = [k for k, v in flat.items()
                          if not torch.equal(layout.shard(k, one[k]), v)]
    del one
    torch.cuda.empty_cache()
    return out


def _mesh_ssm_model(cfg, mesh, one: dict, wrappers: dict,
                    ckpt_dir: Path) -> dict:
    """A rank's calls of a cut model on its shards of the one-process
    run's weights and rows of its batch: the bf16 ES step (measured) held
    as phase ``mesh`` holds the dense step, and its float32 per-sample
    losses; the replicated Mamba2 leaves against the "model" peer's; the
    checkpoint round trip; the bf16 prefill and four decode steps
    (measured: the prefill and the first step) and their float32 reruns
    (flash's plain version), fed the one-process run's tokens."""
    import dataclasses

    from repro_torch.distributed.sharding import make_ctx, shard_tree
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_cache
    from repro_torch.models.transformer import (init_lm, lm_per_sample_loss,
                                                param_axes, tree_leaves,
                                                tree_map)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    axes = param_axes(cfg)

    def shards(ctx):
        full = init_lm(cfg, _gen(dryrun.SEED), "cuda")    # prepare's draws
        local = tree_map(lambda t: t.contiguous().clone(),
                         shard_tree(full, axes, ctx))
        del full
        torch.cuda.empty_cache()
        return local

    shape = ssm_cells()["train"]
    ctx = make_ctx(cfg, mesh, "train")
    lo, n = ctx.local("batch", shape.global_batch)
    batch = {k: v[lo:lo + n].clone() for k, v in dryrun.make_batch(
        cfg, shape.global_batch, shape.seq_len, "cuda",
        _gen(dryrun.SEED)).items()}
    prep = dryrun.prepare(cfg, shape, dryrun.VARIANTS["es"], "cuda",
                          minibatch=MESH_MB, mesh=mesh, params=shards(ctx),
                          batch=batch)
    eng, params, opt = prep.engine, prep.args[0], prep.args[1]
    with torch.no_grad():      # float32 losses, then the bf16 (a warm-up)
        l32 = ctx.all_gather(lm_per_sample_loss(f32, params, batch,
                                                ctx=ctx)[0], "batch", 0)
        losses = ctx.all_gather(lm_per_sample_loss(
            cfg, params, batch, scoring=True, ctx=ctx)[0], "batch", 0)
    res = {"train": {"loss_err": (losses.float().cpu()
                                  - one["losses"]).abs().max().item(),
                     "loss_err_f32": _f32_errs(l32, one["losses_f32"])}}
    train = res["train"]
    p0 = [t.float().cpu() for t in tree_leaves(params)]
    with mesh_counted(wrappers, train):
        state, metrics = prep.step()
    train["selected_equal"] = bool(torch.equal(metrics["selected"].cpu(),
                                               one["selected"]))
    train["m_rel_l2"] = _rel_l2(opt.m, one["m"], axes, ctx)
    train["v_rel_l2"] = _rel_l2(opt.v, one["v"], axes, ctx)
    train["update_err"] = max(
        (p1.cpu() - w).abs().max().item() for p1, w in zip(
            tree_leaves(params), adamw_first_step(
                p0, [t.cpu() for t in tree_leaves(opt.m)],
                [t.cpu() for t in tree_leaves(opt.v)],
                float(metrics["lr_scale"]))))
    res["replicas_differ"] = []
    for name, t in _named_leaves(params):
        if name.split("/")[-1] in SSM_REPLICATED:
            both = ctx.all_gather(t.contiguous()[None], "mlp", 0)
            if not torch.equal(both[0], both[1]):
                res["replicas_differ"].append(name)
    del p0, batch, losses, l32, metrics
    res["ckpt"] = _ckpt_round_trip(eng, state, ckpt_dir)
    del prep, eng, state, params, opt
    torch.cuda.empty_cache()

    dctx = make_ctx(cfg, mesh, "decode")
    params = shards(dctx)
    lo, n = dctx.local("batch", SERVE_B)
    prompts = one["prompts"][lo:lo + n].cuda()
    tokens = one["tokens"][:, lo:lo + n]
    res["prefill"], res["decode"] = {}, {}
    with torch.no_grad():
        cache = init_cache(cfg, SERVE_B, SERVE_P + TEACHER_STEPS,
                           device="cuda", ctx=dctx)
        res["cache_shapes"] = {k: list(v.shape)
                               for k, v in _named_leaves(cache)}
        _, _, res["logit_errs"] = _serve_teacher(
            cfg, params, prompts, cache, dctx, tokens,
            one["logits"][:, lo:lo + n],
            counted=(wrappers, [res["prefill"], res["decode"]]))
        del cache
        cache = init_cache(f32, SERVE_B, SERVE_P + TEACHER_STEPS,
                           dtype=torch.float32, device="cuda", ctx=dctx)
        _, _, res["logit_errs_f32"] = _serve_teacher(
            f32, params, prompts, cache, dctx, tokens,
            one["logits_f32"][:, lo:lo + n], attention=plain_attention)
    del params, cache
    torch.cuda.empty_cache()
    return res


def _named_leaves(tree, prefix: str = ""):
    """(``/``-joined path, leaf) of each leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _mesh_ssm_rank(rank: int, mesh, ref_dir: str) -> dict:
    """One rank of phase ``mesh_ssm``: each cut model of ``ssm_cfgs``
    against the parent's one-process run (``DIR/<name>.pt``)."""
    wrappers = {**_wrappers(), **_xent_halves()}
    res = {"mesh_ssm_child": rank, "coordinate": mesh.get_coordinate()}
    for name, cfg in ssm_cfgs().items():
        one = torch.load(Path(ref_dir) / f"{name}.pt", mmap=True)
        res[name] = _mesh_ssm_model(cfg, mesh, one, wrappers,
                                    Path(ref_dir) / f"ckpt_{name}")
    return res


def mesh_ssm_child(rank: int, port: int, ref_dir: str) -> None:
    """``--mesh-ssm-child RANK PORT DIR``: phase ``mesh_ssm``'s ranks on
    their own (when phase ``mesh`` has not started them)."""
    import torch.distributed as dist
    mesh = _join_mesh(rank, port)
    emit(_mesh_ssm_rank(rank, mesh, ref_dir))
    dist.destroy_process_group()


def phase_mesh_ssm(ranks: Optional["MeshRanks"] = None) -> dict:
    """The SSM and hybrid families sharded over a (2, 2) ("data",
    "model") mesh of four processes on the one card (gloo; ``ranks``:
    phase ``mesh``'s, waiting for this work, else its own):
    mamba2-780m and zamba2-2.7b at published widths, depth cut
    (``SSM_CUTS``), FSDP on; the ES step at S1's traffic, SV's prefill and
    four decode steps. Each rank is held to this process's one-process
    run: the bf16 ES step as phase ``mesh`` holds the dense one (selected
    rows equal, scoring losses within MODEL_TOL, moments within
    ``MESH_M_TOL`` / ``MESH_V_TOL``, weights AdamW's step by them); the
    float32 per-sample losses and the float32 prefill's and decode steps'
    logits within ``MESH_F32_TOL`` x max(1, |x|); the bf16 ones within
    MODEL_TOL (the gap reported); the replicated Mamba2 leaves bitwise
    equal over "model" after the step; the state saved from the four ranks
    and restored onto them and onto one process, bitwise
    (``_ckpt_round_trip``). Each measured
    call (the ES step, the prefill, the first decode step) against the dry
    run's trace of it under a fake group of 4: FLOPs and collectives
    equal, the peak within 5 % or 256 MiB, its launches. Returns the
    ranks' launches."""
    import shutil
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info
    t0 = time.perf_counter()
    cfgs, cells = ssm_cfgs(), ssm_cells()
    pred = {}
    with dryrun.fake_mesh(MESH_SHAPE, MESH_NAMES) as m:
        info = mesh_info(m)
        for name, cfg in cfgs.items():
            pred[name] = {kind: dryrun.count(dryrun.prepare(
                cfg, shape, dryrun.VARIANTS["es"],
                minibatch=MESH_MB if kind == "train" else None, mesh=m),
                info) for kind, shape in cells.items()}
    trace_s = time.perf_counter() - t0
    ref_dir = ranks.dir if ranks is not None else Path(tempfile.mkdtemp())
    try:
        t1 = time.perf_counter()
        for name, cfg in cfgs.items():
            torch.save(_ssm_one_process(cfg), ref_dir / f"{name}.pt")
        one_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        if ranks is None:
            ranks = MeshRanks("--mesh-ssm-child", ref_dir)
        else:
            (ref_dir / "go_ssm").touch()
        got = ranks.wait_for("mesh_ssm_child")
        ranks_s = time.perf_counter() - t1
    finally:
        if ranks is not None:
            ranks.close()
        shutil.rmtree(ref_dir, ignore_errors=True)
    emit({"phase": "mesh_ssm", "mesh": list(MESH_SHAPE), "trace_s": trace_s,
          "one_process_s": one_s, "ranks_s": ranks_s,
          "cuts": {n: list(c) for n, c in SSM_CUTS.items()},
          "bounds": {"loss": MODEL_TOL, "logits_bf16": MODEL_TOL,
                     "f32": f"{MESH_F32_TOL} x max(1, |x|)",
                     "m_rel_l2": MESH_M_TOL, "v_rel_l2": MESH_V_TOL,
                     "update": MESH_UPDATE_TOL, "peak": list(PEAK_SLACK)},
          "predicted": {n: {k: {f: v[f] for f in (
              "flops", "flops_by_dtype", "collectives",
              "collective_bytes_total", "memory", "roofline")}
              for k, v in p.items()} for n, p in pred.items()},
          "ranks": got, "card": smi_line()})
    launches = {"gqa_flash_attention": 0, "fused_xent": 0,
                "fused_score_update": 0}
    for r, g in enumerate(got):
        for name, cfg in cfgs.items():
            res, where = g[name], f"mesh_ssm: rank {r} {name}"
            t = res["train"]
            if not t["selected_equal"]:
                raise AssertionError(f"{where} selected other rows")
            if t["loss_err"] > MODEL_TOL:
                raise AssertionError(f"{where} scoring losses off by "
                                     f"{t['loss_err']}")
            if t["loss_err_f32"] > MESH_F32_TOL:
                raise AssertionError(f"{where} float32 losses off by "
                                     f"{t['loss_err_f32']}")
            if t["m_rel_l2"] > MESH_M_TOL or t["v_rel_l2"] > MESH_V_TOL:
                raise AssertionError(f"{where} moments off: m by "
                                     f"{t['m_rel_l2']}, v by "
                                     f"{t['v_rel_l2']}")
            if not t["update_err"] <= MESH_UPDATE_TOL:
                raise AssertionError(f"{where} weights off AdamW's step by "
                                     f"{t['update_err']}")
            if res["replicas_differ"]:
                raise AssertionError(f"{where} replicated leaves differ "
                                     f"over 'model': "
                                     f"{res['replicas_differ']}")
            ck = res["ckpt"]
            if not (ck["refused"] and "layout" in ck["refused"]):
                raise AssertionError(f"{where} a save without the layout "
                                     f"was not refused")
            if ck["same_grid"] or ck["one_process"]:
                raise AssertionError(f"{where} restores differ: "
                                     f"{ck['same_grid']}, "
                                     f"{ck['one_process']}")
            for i, (_, rel) in enumerate(res["logit_errs"]):
                if rel > MODEL_TOL:
                    raise AssertionError(f"{where} bf16 logits of step {i} "
                                         f"off by {rel}")
            if len(res["logit_errs_f32"]) != TEACHER_STEPS + 1:
                raise AssertionError(f"{where} float32 logits unchecked")
            for e, rel in res["logit_errs_f32"]:
                if rel > MESH_F32_TOL:
                    raise AssertionError(f"{where} float32 logits off by "
                                         f"{e} ({rel} relative)")
            sites = (cfg.num_layers // cfg.hybrid_attn_every
                     if cfg.family == "hybrid" else 0)
            flash = {"gqa_flash_attention": sites} if sites else {}
            want = {"train": {**flash, "xent_partials": 1,
                              "xent_combine": 1, "fused_score_update": 1},
                    "prefill": flash, "decode": {}}
            for kind in ("train", "prefill", "decode"):
                meas = t if kind == "train" else res[kind]
                _held_to_trace(f"{where} {kind}", meas, pred[name][kind],
                               want[kind])
                launches["gqa_flash_attention"] += meas["launches"].get(
                    "gqa_flash_attention", 0)
                launches["fused_xent"] += meas["launches"].get(
                    "xent_partials", 0)
                launches["fused_score_update"] += meas["launches"].get(
                    "fused_score_update", 0)
    return launches


# ---------------------------------------------------------------------------
# phase 12: checkpoint and resume, bitwise, in a deterministic subprocess
# ---------------------------------------------------------------------------

# path -> the step its interrupted run stops at: 2 of 4, or mid-epoch 1 of
# train_eswp (8 of 12 steps), after its second prune decision; train_grown
# at the end of epoch 0, after its grow
RESUME_PATHS = {"train": 2, "train_pipelined": 2, "train_quant": 2,
                "train_eswp": 8, "train_grown": 2, "train_gc": 2,
                "train_preempt": 3}
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


RESUME_ARGS = {**PATH_ARGS, "train_grown": GROWN_ARGS, "train_gc": GC_ARGS,
               "train_preempt": TRAIN_ARGS}
# the script's time: a resume is bitwise or not whatever the depth, so
# every path but ``train`` (the checkpoint cost at full depth) resumes
# qwen1.5-0.5b at its published widths cut to 4 of its 24 layers; the
# write of its 5.57 GB checkpoint took most of the phase's 214 s
RESUME_LAYERS = 4
RESUME_BUILD = {"train_grown": _grown_trainer}


def sigterm_at_step_2(tr, epoch) -> None:
    """A step hook: SIGTERM to this process after step 2 (the trainer's
    handler only sets its preemption flag)."""
    import signal
    if tr.global_step == 2:
        os.kill(os.getpid(), signal.SIGTERM)


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
    if name == "train_preempt":
        # SIGTERM after step 2: the trainer finishes step 3, writes its
        # final checkpoint and stops
        first = build(args + ["--ckpt-dir", str(ckpt_dir)])
        first.step_hooks.append(sigterm_at_step_2)
    else:
        first = build(args + ["--max-steps", str(stop), "--ckpt-dir",
                              str(ckpt_dir)],
                      ckpt_every_steps=2 if name == "train" else 50)
    first.ckpt.keep = 1
    first_out = first.train()
    if first_out["steps"] != stop or first.ckpt.latest_step() != stop:
        raise AssertionError(f"resume {name}: the first run stopped at "
                             f"{first_out['steps']}, its checkpoint at "
                             f"{first.ckpt.latest_step()}, not {stop}")
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


def steps_bench(src: str) -> None:
    """``--steps-bench SRC``: on the port found under SRC, S1's and B's
    trainer runs at 12 steps (each step's ms, and the median step and
    data wait after the first), then each leg of a step as phase ``legs``
    takes them (scoring forward and store, selection, training forward
    and backward, AdamW, the whole ES step), each by the host clock to a
    device sync (median of 5) and by torch.profiler (device ms and
    launches a call). Two trees compare in one call as parent, change,
    change, parent."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    from repro_torch.core.selection import select_minibatch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import apply_updates
    phase_device()
    runs = {}
    for name, args in (("S1", TRAIN_ARGS), ("B", QUANT_ARGS)):
        torch.cuda.empty_cache()
        out = train.main(args + ["--max-steps", "12"])
        torch.cuda.synchronize()
        steps = [r["step_time"] * 1e3 for r in out["metrics"]]
        run = {"step_ms": steps,
               "median_step_ms": statistics.median(steps[1:]),
               "median_data_wait_ms": statistics.median(
                   r["data_wait"] * 1e3 for r in out["metrics"][1:])}
        tr = _trainer(args)
        eng, st = tr.engine, tr.state
        batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))
        w = eng._score_leg(st, batch)[0]
        b = eng.es_cfg.minibatch
        idx = select_minibatch("es", w, b, generator=st.generator)
        sel = {k: v[idx.long()] for k, v in batch.items()}
        grads = eng._loss_and_grads(st.params, sel)[2]
        legs = {"score_forward_and_store": lambda: eng._score_leg(st, batch),
                "select": lambda: select_minibatch("es", w, b,
                                                   generator=st.generator),
                "train_forward_backward": lambda: eng._loss_and_grads(
                    st.params, sel),
                "adamw": lambda: apply_updates(eng.opt_cfg, st.params, grads,
                                               st.opt, 1.0),
                "whole_step": lambda: eng.es_step(st, batch)}
        run["legs"] = {k: {"host_ms": wall_ms(fn, 5), **device_trace(fn, 5)}
                       for k, fn in legs.items()}
        runs[name] = run
        del tr, eng, st, batch, w, sel, grads, out
    emit({"phase": "steps_bench", "src": src,
          "port": str(Path(repro_torch.__file__).parent), "runs": runs,
          "card": smi_line()})


BENCHES = {"--store-bench": store_bench, "--segsum-bench": segsum_bench,
           "--steps-bench": steps_bench}


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
    if len(sys.argv) == 5 and sys.argv[1] == "--cluster-child":
        cluster_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-child":
        mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-moe-child":
        mesh_moe_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-ssm-child":
        mesh_ssm_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if len(sys.argv) > 1:
        sys.exit("usage: chip_smoke.py [--store-bench SRC | --segsum-bench "
                 "SRC | --steps-bench SRC]")
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
    launches, kept = {}, {}
    runs = {**{p: lambda p=p: phase_path(p) for p in PATH_ARGS},
            **{p: lambda p=p: phase_sharded(p) for p in SHARDED_ARGS},
            "train_tokens": phase_train_tokens, "serve": phase_serve,
            "service": phase_service,
            **{p: lambda p=p: phase_family(p) for p in FAMILY_ARGS},
            "serve_mamba2": phase_serve_mamba2,
            "serve_moe": phase_serve_moe,
            **{p: lambda p=p: phase_engine(p) for p in ENGINE_PATHS},
            "serve_vlm": phase_serve_vlm,
            "serve_encdec": phase_serve_encdec, "dryrun": phase_dryrun,
            # phase mesh's four processes go on to phase mesh_moe's work,
            # then to mesh_ssm's
            "mesh": lambda: phase_mesh(kept),
            "mesh_moe": lambda: phase_mesh_moe(kept.pop("ranks"), kept),
            "mesh_ssm": lambda: phase_mesh_ssm(kept.pop("ranks"))}
    for name, run in runs.items():
        for k, v in timed(name, run).items():
            launches[k] = launches.get(k, 0) + v
    for name, fn in (("legs", phase_legs), ("legs_packed", phase_legs_packed),
                     ("data", phase_data),
                     ("legs_pipelined", phase_legs_pipelined),
                     ("memory", phase_memory), ("prune", phase_prune),
                     ("cluster", phase_cluster), ("resume", phase_resume)):
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
