"""Build the port's CUDA kernels into one shared library and load it.

The sources under ``repro_torch/csrc`` have a plain C interface (no PyTorch
headers), so ``nvcc`` builds them in seconds. Each source compiles in its
own ``nvcc`` process, all started together, and the objects link into one
``.so`` under ``build/kernels/`` at the root of the checkout. The file name
carries a hash of the sources and flags, so an edited source is rebuilt and
a current one is loaded as it is. The library is loaded with ``ctypes``:
every pointer and the CUDA stream go in as ``c_void_p``, and every entry
returns ``cudaGetLastError()``.

Nothing here runs at import time. The first wrapper that launches a kernel
on a CUDA tensor calls ``library()``, which builds or raises: there is no
fallback when ``nvcc`` is missing or a build fails.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_ROOTS = ("/usr/local/cuda",)
SOURCES = ("score_update.cu", "xent.cu", "flash_attn.cu", "segsum.cu",
           "quant_score_update.cu", "quant_prologue.cu")
HEADERS = ("hopper.cuh", "block_sort.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry name -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    # s, w, seen, ids, losses, n, B, b1, 1-b1, b2, 1-b2, stream
    "repro_score_update": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P),
    # h, w, labels, partials, M, V, d, n_split, tiles_per_split, stream
    "repro_xent_partials_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # partials, nll, M, n_split, stream
    "repro_xent_combine": (_P, _P, _I, _I, _P),
    # q, k, v, o, B, S, H, K, hd, causal, scale, stream
    "repro_flash_attn_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # nll, seg, mask, sums, counts, B, S, M, stream
    "repro_segment_sum": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # s_q, w_q, seen_q, s_scale, w_scale, err_rows, err_seq, err_s, err_w,
    # ids, gids, losses, slots, seqs, n, B, R, block, b1, 1-b1, b2, 1-b2,
    # stream
    "repro_quant_score_update": (_P,) * 14 + (_I, _I, _I, _I, _F, _F, _F, _F,
                                              _P),
    # s_q, w_q, s_scale, w_scale, err_rows, err_seq, err_s, ids, gids,
    # losses, n, B, R, block, b1, 1-b1, b2, 1-b2, stream
    "repro_quant_grow_scales": (_P,) * 10 + (_I, _I, _I, _I, _F, _F, _F, _F,
                                             _P),
    # err_seq, ids, slots, seqs, n, B, R, stream
    "repro_quant_ring_slots": (_P, _P, _P, _P, _I, _I, _I, _P),
    # stream
    "repro_empty_launch": (_P,),
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # ptxas register / spill report of the last build


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link; return the library path."""
    global build_log
    out = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {name}\n{text}")
        if p.returncode != 0:
            failed.append(name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def on_device(device: torch.device):
    """Context for a launch on ``device``: switches the calling thread's
    current device only when it is another one (the switch costs
    microseconds of host time per call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
