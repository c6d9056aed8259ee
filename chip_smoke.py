#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, ctypes);
2. print the card (``nvidia-smi`` name and power limit, torch's name);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, a ragged shape, the GQA shape (H=32, K=8, hd=128)
   and duplicate plus -1 ids;
4. time each kernel, its plain version and one PyTorch library call with
   CUDA events, and compute each kernel's bound from its shapes;
5. check on a small input that the full-width model's scoring forward
   (kernels) agrees with its training forward (plain autograd path);
6. train full-width qwen1.5-0.5b for 4 serial-ES steps through the
   trainer's CLI entry point, with every kernel's launch count reset just
   before and read just after; assert the counts per step and finite
   losses.

It prints one JSON object per line; the line before the last is the
``kernels`` summary, and the last is the device line. It exits non-zero
without a result when no CUDA device is present or the port is missing.
It imports nothing of JAX and nothing of the JAX package ``repro``.
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
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--full", "--method", "es",
              "--meta-batch", "32", "--minibatch", "8", "--seq-len", "512",
              "--n-samples", "1024", "--max-steps", "4", "--device", "cuda"]
STEPS = 4
# launches per serial-ES step on qwen1.5-0.5b: one xent, one flash per
# layer, one score update
PER_STEP = {"fused_xent": 1, "gqa_flash_attention": 24,
            "fused_score_update": 1}

XENT_TOL = 1e-3     # float32 sums in another order, __expf
# bf16 output (one ulp is 2^-6 at |o| in [2, 4)); probabilities enter PV
# as bf16: |err| <= FLASH_TOL + FLASH_RTOL * |plain|
FLASH_TOL = 2e-2
FLASH_RTOL = 1e-2
SCORE_TOL = 0.0     # same float32 roundings, no FMA contraction


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
        "plain_ms": time_ms(lambda: score_update_ref(
            s, w_, seen, idt, losses, beta1=0.2, beta2=0.9), 10),
        "library_ms": time_ms(score_library, 50),
        "bound_ms": bms, "bound_by": by,
        "shape": {"n": n, "B": Bs}}
    emit({"phase": "time", "kernels": out,
          "card": smi_line()})
    return out


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
}


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
    from repro_torch.kernels.score_update.ops import fused_score_update
    from repro_torch.kernels.xent.ops import fused_xent
    return {"fused_score_update": fused_score_update,
            "fused_xent": fused_xent,
            "gqa_flash_attention": gqa_flash_attention}


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
# phase 6: the trainer, full width, through its CLI entry point
# ---------------------------------------------------------------------------

def phase_train() -> dict:
    from repro_torch.launch import train
    wrappers = _wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    out = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    losses = [r["loss"] for r in out["metrics"]]
    steps = [r["step_time"] * 1e3 for r in out["metrics"]]
    emit({"phase": "train", "args": TRAIN_ARGS, "losses": losses,
          "step_ms": steps, "median_step_ms": statistics.median(steps),
          "median_step_ms_after_first": statistics.median(steps[1:]),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "card": smi_line()})
    if out["steps"] != STEPS or len(losses) != STEPS:
        raise AssertionError(f"trainer ran {out['steps']} steps")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite losses {losses}")
    for name, per_step in PER_STEP.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{STEPS} steps, expected "
                                 f"{per_step * STEPS}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: where one step's time goes
# ---------------------------------------------------------------------------

def phase_legs() -> None:
    """Device time of each leg of one serial-ES step at the trainer's
    shapes (CUDA events, median of 3), and one whole step under
    torch.profiler: device time by kernel and the device's busy share."""
    from repro_torch.core.selection import select_minibatch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import apply_updates
    args = train.build_parser().parse_args(TRAIN_ARGS)
    fields = {f for f in train.TrainerConfig.__dataclass_fields__}
    tr = train.Trainer(train.TrainerConfig(
        **{k: v for k, v in vars(args).items() if k in fields}))
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
    ms = {name: time_ms(fn, 3, warmup=1) for name, fn in legs.items()}
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
        wall_ms = (time.perf_counter() - t0) * 1e3 / active
    # device rows: kernels and copies (the step annotation is not work)
    rows = [(e.self_device_time_total / 1e3 / active, e.count // active,
             e.key[:90]) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not e.key.startswith("ProfilerStep")]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "legs", "leg_ms": ms, "traced_step_wall_ms": wall_ms,
          "traced_step_kernel_ms": device_ms,
          "device_busy_share_traced": device_ms / wall_ms,
          "device_busy_share_untraced": device_ms / ms["whole_step"],
          "kernels_per_step": sum(r[1] for r in rows),
          "top_kernels": [{"ms": r[0], "per_step": r[1], "name": r[2]}
                          for r in rows[:25]],
          "card": smi_line()})
    del tr, eng, st, grads
    torch.cuda.empty_cache()


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
    launches = phase_train()
    phase_legs()
    kernels = []
    for name, meta in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, **meta, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
