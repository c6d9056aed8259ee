"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group of the process, which must hold exactly as many ranks as the mesh
has devices: the fake group of the dry run (``launch/dryrun.py``), or a
gloo group in the CPU tests and on the card (several processes sharing
it). Each rank's mesh coordinate is its rank read row-major over the
mesh's shape; "model" is the innermost dimension.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the default
    group; raises unless the group has as many ranks as the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} devices needs an initialised "
                           f"process group of {n} ranks")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the reference's single- or two-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data",
    "model"): the reference's single- and two-pod meshes."""
    return make_mesh(*production_shape(multi_pod))


def make_mesh_for(n_devices: Optional[int] = None, model_parallel: int = 1):
    """The (data, model) grid of ``n_devices`` (the group's size by
    default) at ``model_parallel``: data parallelism takes what is left
    after model parallelism."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices over model_parallel "
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"))


def mesh_info(mesh) -> dict:
    names = list(mesh.mesh_dim_names)
    return {"axis_names": names,
            "shape": [int(mesh.size(i)) for i in range(len(names))],
            "n_devices": int(mesh.size())}
