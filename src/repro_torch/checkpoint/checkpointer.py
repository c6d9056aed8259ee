"""Atomic, asynchronous, keep-k checkpoints (counterpart of
``repro/checkpoint/checkpointer.py:138-441``, its single-process contract).

A checkpoint is a directory ``step_<N>`` (N zero-padded to 10 digits) that
holds two files:

* ``arrays.pt``: one ``torch.save`` dict of CPU tensors keyed by the
  ``/``-joined path of each leaf of the state (bf16 leaves included, which
  npz cannot hold), and the host arrays of the ``extra/`` channel (the data
  pipeline's cursor arrays) under that prefix;
* ``manifest.json``: ``step``, ``time``, ``leaves`` (shape and dtype of
  each entry) and the caller's ``metadata``.

Writes go to ``step_<N>.tmp``, are fsynced, and are published with one
``os.replace``: a crash mid-write never leaves a broken latest step, and a
step written twice is replaced whole. After each publish only the newest
``keep`` steps remain.

``save_async`` takes the host snapshot before it returns and leaves only
the file write to a thread; ``wait`` joins it and re-raises its error. The
snapshot synchronises the device first (every stream): AdamW updates the
parameters in place, and pipelined ES reads them on a second stream.

``restore`` is driven by a template: each leaf takes the saved tensor of
its path, cast to the template leaf's dtype and device; a leaf the
checkpoint lacks keeps its template value.

Not ported: the partitioned and cluster writes of multi-process runs
(``partition``, ``_write_cluster``, the ``#offset`` row blocks).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_SEP = "/"
_EXTRA = "extra/"
_ARRAYS = "arrays.pt"


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts of tensors -> {``/``-joined path: tensor}."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-len(_SEP)]: tree}


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{``/``-joined path: leaf} -> nested dicts (``flatten``'s inverse)."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split(_SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        # one entry a snapshot, write or restore: {"op", "seconds"} (and a
        # snapshot's "async", a write's "bytes" on disk), in the order
        # they ended
        self.timings: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def _snapshot(self, state: Any, extras: Optional[Dict[str, np.ndarray]],
                  is_async: bool) -> Dict[str, torch.Tensor]:
        """Host copies of every leaf and extra, taken now."""
        t0 = time.perf_counter()
        flat = flatten(state)
        if any(t.is_cuda for t in flat.values()):
            torch.cuda.synchronize()     # every stream of the device
        host = {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}
        for k, v in (extras or {}).items():
            host[_EXTRA + k] = torch.from_numpy(np.array(v))
        self.timings.append({"op": "snapshot", "async": is_async,
                             "seconds": time.perf_counter() - t0})
        return host

    def save(self, state: Any, step: int,
             metadata: Optional[Dict] = None,
             extras: Optional[Dict[str, np.ndarray]] = None) -> Path:
        """Write ``state`` (nested dicts of tensors) as ``step`` now."""
        self.wait()         # after any save still in flight
        host = self._snapshot(state, extras, False)
        return self._write(host, step, dict(metadata or {}))

    def save_async(self, state: Any, step: int,
                   metadata: Optional[Dict] = None,
                   extras: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Snapshot ``state`` now; write it on a thread (``wait`` joins)."""
        self.wait()
        host = self._snapshot(state, extras, True)
        md = dict(metadata or {})

        def work():
            try:
                self._write(host, step, md)
            except BaseException as e:  # re-raised by the next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, host: Dict[str, torch.Tensor], step: int,
               metadata: Dict) -> Path:
        t0 = time.perf_counter()
        final = self.step_dir(step)
        tmp = Path(str(final) + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(host, tmp / _ARRAYS)
        manifest = {"step": step, "time": time.time(),
                    "leaves": {k: {"shape": list(v.shape),
                                   "dtype": _dtype_name(v)}
                               for k, v in host.items()},
                    "metadata": metadata}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        nbytes = 0
        for f in tmp.iterdir():
            with open(f, "rb") as fh:
                os.fsync(fh.fileno())
            nbytes += f.stat().st_size
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        self.timings.append({"op": "write", "bytes": nbytes,
                             "seconds": time.perf_counter() - t0})
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def _step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step

    def _load(self, step: int) -> Dict[str, torch.Tensor]:
        # mapped: a caller that reads a few entries reads only those
        return torch.load(self.step_dir(step) / _ARRAYS, map_location="cpu",
                          weights_only=True, mmap=True)

    def restore(self, template: Dict, step: Optional[int] = None) -> Dict:
        """``template`` (nested dicts of tensors) with each leaf loaded
        from ``step`` (default: the latest), cast to the leaf's dtype and
        device; leaves the checkpoint lacks keep their template value."""
        t0 = time.perf_counter()
        step = self._step(step)
        data = self._load(step)
        out, missing = {}, []
        for key, leaf in flatten(template).items():
            arr = data.get(key)
            if arr is None:
                missing.append(key)
                out[key] = leaf
            elif arr.shape != leaf.shape:
                raise ValueError(f"restore: {key} has shape "
                                 f"{tuple(arr.shape)} in step {step}, the "
                                 f"template {tuple(leaf.shape)}")
            else:
                out[key] = arr.to(device=leaf.device, dtype=leaf.dtype,
                                  copy=True)
        if missing:
            print(f"[restore] {len(missing)} leaves absent from the "
                  f"checkpoint keep their template value: "
                  f"{', '.join(missing[:8])}")
        self.timings.append({"op": "restore",
                             "seconds": time.perf_counter() - t0})
        return unflatten(out)

    def extras(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The host arrays saved beside ``step``'s state."""
        return {k[len(_EXTRA):]: v.numpy().copy()
                for k, v in self._load(self._step(step)).items()
                if k.startswith(_EXTRA)}

    def manifest(self, step: Optional[int] = None) -> Dict:
        return json.loads((self.step_dir(self._step(step))
                           / "manifest.json").read_text())
