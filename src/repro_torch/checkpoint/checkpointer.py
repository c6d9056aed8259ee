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

Multi-process runs (the reference's layout, ``checkpointer.py:101-135,
185-236, 290-345``), two cases:

* no ``partition``: every process holds the same state, and only process
  0 writes it (``_writer_only``);
* ``partition=`` (``Store.checkpoint_partition()``, per-process score
  rows): each process's leaves under the partition's prefixes are only its
  row range, saved as blocks keyed ``<path>#<offset>`` (the offset is the
  process's first row, or with ``per_leaf`` its rank times the leaf's
  length: the int8 store's rows, scales and ring slots split evenly).
  With a comm (``_write_cluster``) process 0 writes ``arrays.pt`` (its
  blocks and every other leaf) and the manifest, which records the union
  of every process's leaves, and process p writes ``arrays.part<p>.pt``.

Restore merges every ``arrays*.pt`` of the step, assembles a leaf from
its blocks, and, under a ``partition``, slices it to the template's row
range. So a checkpoint of any process count restores on any other,
replicated or in row blocks. The directory must be one every process
reads.

A model-sharded state (``ESEngine(ctx=...)`` on a mesh; the reference's
``_to_host``, ``_sharding_desc`` and ``restore``, :61-110, :410-416)
holds each rank's shards of the parameters and moments. Its ``Layout``
(``ESEngine.checkpoint_layout()``: each leaf's logical axes and the
``ShardCtx``) is passed as ``layout=``:

* ``save`` gathers each split leaf whole, one leaf at a time (all-gather
  over its mesh dims, a host copy, the gathered tensor freed: the whole
  state never sits on one device), and process 0 writes it under its
  global name; the manifest records each leaf's axes and the mesh's
  shape (provenance only);
* ``restore`` slices each whole leaf to this rank's shard by the
  template's layout (``ShardCtx.local``), or, with no layout (one
  process), takes it whole. The same grid, another grid and one process
  all restore through this one path.

``ESEngine.state_dict`` on a mesh returns a ``ShardTree``, a dict that
says it holds shards: ``save`` refuses it without a layout, naming its
first split leaf, rather than write process 0's shards as the state.
"""
from __future__ import annotations

import dataclasses
import functools
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
_BLOCK = "#"     # <path>#<offset>: a row block of a process-owned leaf


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


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which leaves of a state tree are a rank's shards: ``axes`` (nested
    as the state; a leaf it does not name is whole on every rank) gives
    each split leaf's logical axes, ``ctx`` the ``ShardCtx`` that maps
    them onto the mesh."""
    axes: Dict[str, Any]
    ctx: Any

    @functools.cached_property
    def split(self) -> Dict[str, tuple]:
        """{leaf path: logical axes} of the leaves split over the mesh."""
        return {k: a for k, a in flatten(self.axes).items()
                if a and any(self.ctx.size(x) > 1 for x in a)}

    def gather(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``path`` from this rank's shard ``t`` (every rank
        calls: an all-gather a split dimension)."""
        for dim, a in enumerate(self.split.get(path, ())):
            if self.ctx.size(a) > 1:
                t = self.ctx.all_gather(t.contiguous(), a, dim)
        return t

    def shard(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``path``."""
        for dim, a in enumerate(self.split.get(path, ())):
            lo, n = self.ctx.local(a, t.shape[dim])
            t = t.narrow(dim, lo, n)
        return t

    def describe(self) -> Dict[str, Any]:
        """The manifest's record: the mesh and each split leaf's axes."""
        mesh = self.ctx.mesh
        return {"mesh": {"axis_names": list(mesh.mesh_dim_names),
                         "shape": list(mesh.mesh.shape)},
                "axes": {k: list(a) for k, a in self.split.items()}}


class ShardTree(dict):
    """A state tree that holds this rank's shards of the leaves
    ``layout`` names (``ESEngine.state_dict`` on a mesh)."""

    def __init__(self, tree: Dict, layout: Layout):
        super().__init__(tree)
        self.layout = layout


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _block_offset(partition: Dict, leaf) -> int:
    """A process-owned leaf's first row in the assembled array."""
    if partition.get("per_leaf"):
        return int(partition.get("rank", 0)) * int(leaf.shape[0])
    return int(partition.get("offset", 0))


def _split_partitioned(flat: Dict[str, torch.Tensor],
                       partition: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """Rename the process-owned leaves to their offset-tagged block keys."""
    if not partition:
        return dict(flat)
    prefixes = tuple(partition.get("prefixes", ()))
    return {(f"{k}{_BLOCK}{_block_offset(partition, v):012d}"
             if prefixes and k.startswith(prefixes) else k): v
            for k, v in flat.items()}


def _assemble_blocks(data: Dict[str, torch.Tensor], key: str
                     ) -> Optional[torch.Tensor]:
    """The full leaf from its offset-tagged row blocks, if it has any."""
    pre = key + _BLOCK
    blocks = {int(k[len(pre):]): v for k, v in data.items()
              if k.startswith(pre)}
    if not blocks:
        return None
    offs = sorted(blocks)
    n = offs[-1] + blocks[offs[-1]].shape[0]
    out = torch.zeros((n,) + tuple(blocks[offs[0]].shape[1:]),
                      dtype=blocks[offs[0]].dtype)
    for o in offs:
        out[o:o + blocks[o].shape[0]] = blocks[o]
    return out


def _writer_only() -> bool:
    """False on every process but 0 of a multi-process run: with no
    partition each process holds the same state, and writing it from
    every one would race the same directory."""
    from ..distributed.hostcomm import get_comm
    comm = get_comm()
    return comm is None or comm.process_index == 0


def _with_layout(metadata: Optional[Dict], layout: Optional[Layout]
                 ) -> Dict:
    """The caller's metadata, with a layout's record under "layout"."""
    md = dict(metadata or {})
    if layout is not None:
        md["layout"] = layout.describe()
    return md


def _descriptors(host: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    return {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
            for k, v in host.items()}


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
                  is_async: bool, partition: Optional[Dict] = None,
                  layout: Optional[Layout] = None
                  ) -> Dict[str, torch.Tensor]:
        """Host copies of every leaf (process-owned ones block-keyed, a
        layout's split leaves gathered whole) and extra, taken now. A
        process that writes no whole leaf (not process 0) keeps only its
        blocks."""
        t0 = time.perf_counter()
        if layout is None and isinstance(state, ShardTree) \
                and state.layout.split:
            first, axes = next(iter(state.layout.split.items()))
            raise ValueError(
                f"save: {first} is this rank's shard of a model-sharded "
                f"state (axes {axes}); pass layout= "
                f"(ESEngine.checkpoint_layout()) to save it whole")
        flat = _split_partitioned(flatten(state), partition)
        for dev in {t.device for t in flat.values() if t.is_cuda}:
            torch.cuda.synchronize(dev)  # every stream of the device
        writer = _writer_only()
        host = {}
        for k, t in flat.items():
            if layout is not None:   # every rank gathers; the copy is freed
                t = layout.gather(k, t.detach())
            if writer or _BLOCK in k:
                host[k] = t.detach().to("cpu", copy=True)
            del t
        for k, v in (extras or {}).items():
            host[_EXTRA + k] = torch.from_numpy(np.array(v))
        self.timings.append({"op": "snapshot", "async": is_async,
                             "seconds": time.perf_counter() - t0})
        return host

    def save(self, state: Any, step: int,
             metadata: Optional[Dict] = None,
             extras: Optional[Dict[str, np.ndarray]] = None,
             partition: Optional[Dict] = None,
             layout: Optional[Layout] = None) -> Path:
        """Write ``state`` (nested dicts of tensors) as ``step`` now;
        ``partition`` marks the leaves that cover only this process's
        rows (every process then takes part in the write), ``layout`` the
        leaves that are this rank's shards of a model-sharded state (every
        rank takes part in their gathers)."""
        self.wait()         # after any save still in flight
        host = self._snapshot(state, extras, False, partition, layout)
        md = _with_layout(metadata, layout)
        comm = (partition or {}).get("comm")
        if comm is not None:
            return self._write_cluster(host, step, md, partition, comm)
        if not _writer_only():
            return self.step_dir(step)     # process 0 writes for the run
        return self._write(host, step, md)

    def save_async(self, state: Any, step: int,
                   metadata: Optional[Dict] = None,
                   extras: Optional[Dict[str, np.ndarray]] = None,
                   partition: Optional[Dict] = None,
                   layout: Optional[Layout] = None) -> None:
        """Snapshot ``state`` now (a layout's gathers included); write it on
        a thread (``wait`` joins). A cluster write stays on the caller's
        thread: its barriers must keep the collectives' order."""
        if (partition or {}).get("comm") is not None:
            self.save(state, step, metadata, extras, partition, layout)
            return
        self.wait()
        host = self._snapshot(state, extras, True, partition, layout)
        if not _writer_only():
            return
        md = _with_layout(metadata, layout)

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
    def _publish(self, tmp: Path, step: int, leaves: Dict[str, Dict],
                 metadata: Dict) -> int:
        """Manifest, fsync, one atomic rename, then keep-k -> bytes on
        disk: the tail every writer goes through."""
        manifest = {"step": step, "time": time.time(), "leaves": leaves,
                    "metadata": metadata}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        nbytes = 0
        for f in tmp.iterdir():
            with open(f, "rb") as fh:
                os.fsync(fh.fileno())
            nbytes += f.stat().st_size
        final = self.step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return nbytes

    def _tmp(self, step: int) -> Path:
        tmp = Path(str(self.step_dir(step)) + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    def _write(self, host: Dict[str, torch.Tensor], step: int,
               metadata: Dict) -> Path:
        t0 = time.perf_counter()
        tmp = self._tmp(step)
        torch.save(host, tmp / _ARRAYS)
        nbytes = self._publish(tmp, step, _descriptors(host), metadata)
        self.timings.append({"op": "write", "bytes": nbytes,
                             "seconds": time.perf_counter() - t0})
        return self.step_dir(step)

    def _write_cluster(self, host: Dict[str, torch.Tensor], step: int,
                       metadata: Dict, partition: Dict, comm) -> Path:
        """Barrier-ordered write of every process: process 0 writes
        ``arrays.pt`` (its blocks and every other leaf) and the manifest,
        process p its blocks to ``arrays.part<p>.pt``; the leaves'
        descriptors are exchanged so the manifest records their union."""
        t0 = time.perf_counter()
        p = comm.process_index
        tmp = self._tmp(step) if p == 0 else \
            Path(str(self.step_dir(step)) + ".tmp")
        comm.barrier("ckpt-mkdir")
        mine = host if p == 0 else {k: v for k, v in host.items()
                                    if _BLOCK in k}
        torch.save(mine, tmp / (_ARRAYS if p == 0 else
                                f"arrays.part{p}.pt"))
        # the allgather also orders every part's write before the publish
        packed = comm.allgather(np.frombuffer(
            json.dumps(_descriptors(mine)).encode(), np.uint8))
        nbytes = 0
        if p == 0:
            leaves = {}
            for buf in packed:
                leaves.update(json.loads(bytes(buf).decode()))
            md = dict(metadata, process_count=comm.process_count,
                      partitioned={"prefixes": list(partition["prefixes"]),
                                   "n_global": int(partition["n_global"])})
            nbytes = self._publish(tmp, step, leaves, md)
        comm.barrier("ckpt-done")
        self.timings.append({"op": "write", "bytes": nbytes,
                             "seconds": time.perf_counter() - t0})
        return self.step_dir(step)

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

    def _load(self, step: int, name: str = _ARRAYS
              ) -> Dict[str, torch.Tensor]:
        # mapped: a caller that reads a few entries reads only those
        return torch.load(self.step_dir(step) / name, map_location="cpu",
                          weights_only=True, mmap=True)

    def _load_all(self, step: int) -> Dict[str, torch.Tensor]:
        """Every array file of the step merged (block keys are unique)."""
        data: Dict[str, torch.Tensor] = {}
        for f in sorted(self.step_dir(step).glob("arrays*.pt")):
            data.update(self._load(step, f.name))
        return data

    def restore(self, template: Dict, step: Optional[int] = None,
                partition: Optional[Dict] = None,
                layout: Optional[Layout] = None) -> Dict:
        """``template`` (nested dicts of tensors) with each leaf loaded
        from ``step`` (default: the latest), cast to the leaf's dtype and
        device; leaves the checkpoint lacks keep their template value.

        A leaf saved as row blocks is assembled whole; under a
        ``partition`` (this run's per-process rows) a leaf of its prefixes
        is sliced to the template's row range, so any process count
        restores any other. Under a ``layout`` (the template's: a
        model-sharded state) each split leaf is sliced to this rank's
        shard; with none, every leaf is taken whole."""
        t0 = time.perf_counter()
        step = self._step(step)
        data = self._load_all(step)
        prefixes = tuple((partition or {}).get("prefixes", ()))
        out, missing = {}, []
        for key, leaf in flatten(template).items():
            arr = data.get(key)
            if arr is None:
                arr = _assemble_blocks(data, key)
            if arr is not None and layout is not None:
                arr = layout.shard(key, arr)
            if arr is not None and prefixes and key.startswith(prefixes) \
                    and arr.shape[:1] != leaf.shape[:1]:
                o = _block_offset(partition, leaf)
                arr = arr[o:o + leaf.shape[0]]
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
