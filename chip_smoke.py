#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each of which raises on failure (nothing is caught):

1. ``build`` the five CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together; ctypes);
2. ``device``: the card (``nvidia-smi`` name and power limit, torch's name);
3. ``check`` each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged shapes, with duplicate, -1 and
   out-of-range ids, a warm residual ring and ring slots >= R;
4. ``time`` each kernel, its plain version and one PyTorch library call
   with CUDA events (the microsecond kernels also alone, under
   torch.profiler), and compute each kernel's bound from its inputs;
5. ``model``: the full-width scoring forward (kernels) against the training
   forward (plain autograd) on a small input;
6. the three main paths on full-width qwen1.5-0.5b through the trainer's
   CLI entry point, 4 steps each, every launch count set to 0 just before
   and read just after: ``train`` (serial ES, f32 store), ``train_packed``
   (packed token-level ES, ``--pack``) and ``train_quant`` (serial ES over
   the int8 store, ``--quant-scores``); the counts per step and finite
   losses are asserted;
7. ``legs``: where a step's time goes (serial-ES legs and a profiled step;
   the packed step's legs; the int8 store update against the f32 one and
   its profiled launches). Legs are timed as the trainer times a step: host
   clock around a call that ends in a device sync.

It prints one JSON object per line; the line before the last is the
``kernels`` summary, and the last is the device line. It
exits non-zero without a result when no CUDA device is present or the port
is missing. It imports nothing of JAX and nothing of the JAX package
``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
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
QUANT_ARGS = FULL + ["--quant-scores", "--quant-block", "1024",
                     "--meta-batch", "32", "--minibatch", "8",
                     "--n-samples", "65536"]
STEPS = 4
# launches per step of each path on qwen1.5-0.5b (24 layers); a kernel
# left out of a path's dict must not launch there
PER_STEP = {
    # serial ES: one xent, one flash per layer, one f32 score update
    "train": {"fused_xent": 1, "gqa_flash_attention": 24,
              "fused_score_update": 1},
    # packed: one differentiated forward (plain attention and xent), one
    # segment sum, one f32 score update over the 64 document slots
    "train_packed": {"segment_sum": 1, "fused_score_update": 1},
    # serial ES over the int8 store
    "train_quant": {"fused_xent": 1, "gqa_flash_attention": 24,
                    "fused_quant_score_update": 1},
}

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


def _device_rows(fn, reps: int) -> list:
    """torch.profiler's device rows (kernels and copies) over ``reps``
    calls of ``fn``, after one untraced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


def device_trace(fn, reps: int = 20) -> dict:
    """Device launches per call of ``fn`` and their device time per call."""
    rows = _device_rows(fn, reps)
    return {"launches_per_call": sum(e.count for e in rows) / reps,
            "device_ms": sum(e.self_device_time_total
                             for e in rows) / 1e3 / reps}


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of one launch of the CUDA kernel named ``kernel``
    over ``reps`` calls of ``fn``, from torch.profiler. For kernels that
    take microseconds the CUDA events of ``time_ms`` read the wrapper's
    host path (checks, allocation, the ctypes call) while the device
    idles; this reads the kernel alone."""
    rows = [e for e in _device_rows(fn, reps) if kernel in e.key]
    count = sum(e.count for e in rows)
    if count != reps:
        raise AssertionError(f"profiler saw {count} launches of {kernel}, "
                             f"expected {reps}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


# ---------------------------------------------------------------------------
# phases 1-2: build, device
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.library()
    resources = [ln.strip() for ln in _build.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or ln.startswith("==")]
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
        raise AssertionError(f"score_update n={n}: max |err| {err} > "
                             f"{SCORE_TOL}")
    return err


def segsum_inputs(B: int, S: int, M: int, seed: int = 0):
    """Random per-token NLL, segment ids in [0, M+1] (M+1 is in no slot)
    and a live mask."""
    g = _gen(seed)
    nll = 5 * torch.rand(B, S, device="cuda", generator=g)
    seg = torch.randint(0, M + 2, (B, S), device="cuda", generator=g,
                        dtype=torch.int32)
    mask = torch.rand(B, S, device="cuda", generator=g) < 0.9
    return nll, seg, mask


def packed_segsum_inputs(seed: int = 0):
    """Path A's layout: the first 16 rows of the packed source the trainer
    builds (1024 documents, S = 512, M = 4), random per-token NLL."""
    import numpy as np
    from repro_torch.data.packed import PackedSource
    src = PackedSource.synthetic(1024, 512, max_segments=4, vocab=64, seed=0)
    b = src.batch(np.arange(16))
    seg = torch.from_numpy(b["segment_ids"]).cuda()
    mask = torch.from_numpy(b["labels"] != -1).cuda()
    nll = 5 * torch.rand(16, 512, device="cuda", generator=_gen(seed))
    return nll, seg, mask


def check_segsum(nll, seg, mask, M: int) -> float:
    from repro_torch.kernels.segsum.ops import (segment_sum,
                                                segment_sum_autograd)
    from repro_torch.kernels.segsum.ref import segment_sum_ref
    got_s, got_c = segment_sum(nll, seg, mask, max_segments=M)
    want_s, want_c = segment_sum_ref(nll, seg, mask, max_segments=M)
    torch.cuda.synchronize()
    if not torch.equal(got_c, want_c):
        raise AssertionError(f"segsum {tuple(nll.shape)} M={M}: counts "
                             f"differ")
    diff = (got_s - want_s).abs()
    if not bool((diff <= SEGSUM_RTOL * want_s.abs().clamp(min=1.0)).all()):
        raise AssertionError(f"segsum {tuple(nll.shape)} M={M}: max |err| "
                             f"{diff.max().item()} beyond {SEGSUM_RTOL} "
                             f"relative")
    # the autograd.Function's backward against autograd through the plain
    # version (the same gather of the upstream gradient: exact)
    up = torch.rand(nll.shape[0], M, device="cuda", generator=_gen(9))
    grads = []
    for fn in (segment_sum_autograd, segment_sum_ref):
        x = nll.clone().requires_grad_(True)
        (fn(x, seg, mask, max_segments=M)[0] * up).sum().backward()
        grads.append(x.grad)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError(f"segsum {tuple(nll.shape)}: backward differs")
    return diff.max().item()


QUANT_NAMES = ("s_q", "w_q", "seen_q", "err_rows", "err_seq", "err_s",
               "err_w")


def quant_inputs(n: int, B: int, R: int, block: int, seed: int = 0):
    """Arguments of the int8 kernel after the store's own prologue, on a
    store warmed by one update of the same rows (so the ring holds their
    residuals): duplicate ids, -1 and out-of-range ids, and two slots
    forced to R (residual dropped)."""
    from repro_torch.core.scores import (_q_grow_scales, _q_ring_slots,
                                         make_store)
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
    pos = torch.where(mask, ids, torch.zeros_like(ids))
    mg = torch.where(mask, ids, torch.full_like(ids, -1))
    _q_grow_scales(qs, pos, mask, mg, losses, 0.2, 0.9, block)
    slots, seqs = _q_ring_slots(qs.err_seq, mask)
    slots[2] = R
    slots[9] = R + 5
    lids = torch.where(mask, pos, torch.full_like(pos, -1))
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


def phase_check() -> dict:
    errs = {
        "fused_xent": max(check_xent(16384, 151936, 1024),
                          check_xent(300, 777, 64),
                          check_xent(200, 1000, 1024)),
        "gqa_flash_attention": max(
            check_flash(32, 512, 16, 16, 64, True),
            check_flash(2, 200, 4, 4, 64, True),
            check_flash(2, 200, 4, 4, 64, False),
            check_flash(2, 256, 32, 8, 128, True),
            check_flash(1, 128, 4, 2, 16, True)),
        "fused_score_update": max(
            check_score(1024, _perm(1024, 32)),
            check_score(64, [3, 3, -1, 70, 5, 3, 63, -7])),
        "segment_sum": max(check_segsum(*packed_segsum_inputs(), 4),
                           check_segsum(*segsum_inputs(7, 300, 5), 5),
                           check_segsum(*segsum_inputs(16, 512, 8), 8)),
        "fused_quant_score_update": max(check_quant(65536, 32, 1024, 1024),
                                        check_quant(1000, 32, 16, 64)),
    }
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
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.score_update.ops import fused_score_update
    from repro_torch.kernels.score_update.ref import score_update_ref
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
        "plain_ms": time_ms(lambda: xent_ref(h, w, labels), 3),
        "library_ms": time_ms(xent_library, 3),
        "bound_ms": bms, "bound_by": by,
        "shape": {"M": M, "V": V, "d": d}}
    del h, w, labels
    torch.cuda.empty_cache()

    B, S, H, K, hd = 32, 512, 16, 16, 64
    q, k, v = flash_inputs(B, S, H, K, hd)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = B * H * S * (S + 1) / 2          # causal (query, key) pairs
    flops = 4.0 * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    bms, by = bound(flops, nbytes)
    out["gqa_flash_attention"] = {
        "ms": time_ms(lambda: gqa_flash_attention(q, k, v), 20),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20),
        "bound_ms": bms, "bound_by": by,
        "shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd}}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

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

    # each id reads s, seen and writes s, w, seen; ids and losses read once
    nbytes = Bs * (4 + 4) + Bs * (4 * 2 + 4 * 3)
    bms, by = bound(0.0, nbytes)
    out["fused_score_update"] = {
        "ms": time_ms(lambda: fused_score_update(
            s, w_, seen, idt, losses, beta1=0.2, beta2=0.9), 50),
        "device_ms": kernel_device_ms(lambda: fused_score_update(
            s, w_, seen, idt, losses, beta1=0.2, beta2=0.9),
            "::score_update_kernel"),
        "plain_ms": time_ms(lambda: score_update_ref(
            s, w_, seen, idt, losses, beta1=0.2, beta2=0.9), 10),
        "library_ms": time_ms(score_library, 50),
        "bound_ms": bms, "bound_by": by,
        "shape": {"n": n, "B": Bs}}

    out["segment_sum"] = time_segsum()
    out["fused_quant_score_update"] = time_quant()
    emit({"phase": "time", "kernels": out,
          "card": smi_line()})
    return out


def time_segsum() -> dict:
    """Path A's shapes: B = 16 rows of S = 512, M = 4 slots."""
    from repro_torch.kernels.segsum.ops import segment_sum
    from repro_torch.kernels.segsum.ref import segment_sum_ref
    M = 4
    nll, seg, mask = packed_segsum_inputs()
    B, S = nll.shape
    live = mask & (seg >= 1) & (seg <= M)
    col = torch.where(live, seg, torch.zeros_like(seg)).long()

    def library():
        # one scatter_add_ into M+1 slots (slot 0 takes the dead tokens)
        return torch.zeros(B, M + 1, device="cuda").scatter_add_(1, col, nll)

    # a float add and an int add per live token; nll, seg, mask read once,
    # sums and counts written once
    flops = 2.0 * int(live.sum())
    nbytes = B * S * (4 + 4 + 1) + 2 * B * M * 4
    bms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    return {
        "ms": time_ms(lambda: segment_sum(nll, seg, mask, max_segments=M),
                      50),
        "device_ms": kernel_device_ms(
            lambda: segment_sum(nll, seg, mask, max_segments=M),
            "segsum_kernel"),
        "plain_ms": time_ms(lambda: segment_sum_ref(nll, seg, mask,
                                                    max_segments=M), 20),
        "library_ms": time_ms(library, 50),
        "bound_ms": bms, "bound_by": by,
        "shape": {"B": B, "S": S, "M": M}}


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
    "fused_quant_score_update": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/quant_score_update.cu",
        "replaces": "src/repro/kernels/score_update/score_update.py:186"},
}


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.score_update.ops import (
        fused_quant_score_update, fused_score_update)
    from repro_torch.kernels.segsum.ops import segment_sum
    from repro_torch.kernels.xent.ops import fused_xent
    return {"fused_score_update": fused_score_update,
            "fused_xent": fused_xent,
            "gqa_flash_attention": gqa_flash_attention,
            "segment_sum": segment_sum,
            "fused_quant_score_update": fused_quant_score_update}


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
# phase 6: the trainer's three paths, full width, through its CLI
# ---------------------------------------------------------------------------

PATH_ARGS = {"train": TRAIN_ARGS, "train_packed": PACK_ARGS,
             "train_quant": QUANT_ARGS}


def phase_path(name: str) -> dict:
    """Run one path through ``train.main`` with every launch count set to
    0 just before and read just after."""
    from repro_torch.launch import train
    args = PATH_ARGS[name]
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    out = train.main(args)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    losses = [r["loss"] for r in out["metrics"]]
    steps = [r["step_time"] * 1e3 for r in out["metrics"]]
    emit({"phase": name, "args": args, "losses": losses,
          "bp_samples_total": out["bp_samples_total"],
          "step_ms": steps, "median_step_ms": statistics.median(steps),
          "median_step_ms_after_first": statistics.median(steps[1:]),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "card": smi_line()})
    if out["steps"] != STEPS or len(losses) != STEPS:
        raise AssertionError(f"{name}: trainer ran {out['steps']} steps")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    for k in wrappers:
        want = PER_STEP[name].get(k, 0) * STEPS
        if launches[k] != want:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"in {STEPS} steps, expected {want}")
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


def _trainer(args):
    from repro_torch.launch import train
    ns = train.build_parser().parse_args(args)
    fields = set(train.TrainerConfig.__dataclass_fields__)
    return train.Trainer(train.TrainerConfig(
        **{k: v for k, v in vars(ns).items() if k in fields}))


def phase_legs_packed() -> None:
    """Time of the packed step's legs at path A's shapes (host clock to a
    device sync, median of 3): the differentiated forward + backward (the
    segment sum inside), the segment-sum kernel alone, the f32 store
    update over the 64 document slots, AdamW and one whole step with its
    peak memory. Then the int8 store's update (grow/recode prologue, ring
    slots and kernel) against the f32 kernel at path B's B = 32 and
    n = 65,536, and the kernels each launches per call, under
    torch.profiler."""
    from repro_torch.core.engine import _value_and_grad
    from repro_torch.core.scores import (_q_grow_scales, _q_ring_slots,
                                         make_store)
    from repro_torch.kernels.segsum.ops import segment_sum
    from repro_torch.models.transformer import lm_per_segment_loss
    from repro_torch.optim.adamw import apply_updates
    tr = _trainer(PACK_ARGS)
    eng, st = tr.engine, tr.state
    batch = tr._place(tr.ds.batch(tr.sampler.batch_ids(0, 0)))

    def fwd_bwd():
        return _value_and_grad(st.params, lambda: (lm_per_segment_loss(
            eng.model_cfg, st.params, batch)[0].mean(), None))

    _, _, grads = fwd_bwd()
    ids = batch["doc_ids"].reshape(-1)
    losses = 3 * torch.rand(ids.shape[0], device="cuda", generator=_gen(3))
    nll = 5 * torch.rand(batch["labels"].shape, device="cuda",
                         generator=_gen(4))
    seg = batch["segment_ids"].contiguous()
    live = (batch["labels"] != -1).contiguous()
    legs = {
        "forward_backward": fwd_bwd,
        "segment_sum": lambda: segment_sum(nll, seg, live, max_segments=4),
        "store_update": lambda: eng.store.update(st.scores, ids, losses, 0.2,
                                                 0.9),
        "adamw": lambda: apply_updates(eng.opt_cfg, st.params, grads, st.opt,
                                       1.0),
        "whole_step": lambda: eng.packed_step(st, batch),
    }
    ms = {name: wall_ms(fn, 3) for name, fn in legs.items()}
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
    mask = torch.ones(B, dtype=torch.bool, device="cuda")

    def prologue():
        _q_grow_scales(qs, sid, mask, sid, sl, 0.2, 0.9, block)
        return _q_ring_slots(qs.err_seq, mask)

    store = {
        "f32_update": lambda: f32.update(fs, sid, sl, 0.2, 0.9),
        "int8_update": lambda: quant.update(qs, sid, sl, 0.2, 0.9),
        "int8_prologue": prologue,
    }
    store_ms = {k: wall_ms(fn, 20, warmup=2) for k, fn in store.items()}
    trace = {k: device_trace(fn) for k, fn in store.items()}
    emit({"phase": "legs_packed", "args": PACK_ARGS, "leg_ms": ms,
          "legs_sum_ms": sum(v for k, v in ms.items()
                             if k not in ("whole_step", "segment_sum")),
          "whole_step_peak_memory": peak,
          "store_update_ms": store_ms, "store_update_trace": trace,
          "store_shape": {"n": n, "B": B, "block": block},
          "card": smi_line()})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_device()
    errs = phase_check()
    times = phase_time()
    phase_model()
    launches = {}
    for path in PATH_ARGS:
        for k, v in phase_path(path).items():
            launches[k] = launches.get(k, 0) + v
    phase_legs()
    phase_legs_packed()
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
            "device_ms": t.get("device_ms")})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
