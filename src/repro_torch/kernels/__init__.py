"""Hand-written CUDA kernels of the port, one folder each.

Each folder holds ``ops.py`` (the wrapper: checks, launch, launch count)
and ``ref.py`` (the plain PyTorch version of the same function). The CUDA
sources live in ``repro_torch/csrc`` and are built by ``_build.py`` at
first use. Counterparts of the Pallas kernels in ``repro/kernels``.
"""
from __future__ import annotations

import torch


def on_card_route(x) -> bool:
    """Does a tensor (or device) ``x`` take the kernels' route: a CUDA
    tensor launches them; a ``meta`` one (the dry run's trace,
    ``launch/dryrun.py``) follows the same route and stops short of each
    launch. Any other device takes the plain version (CPU) or is refused."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type in ("cuda", "meta")


def dry(t: torch.Tensor) -> bool:
    """Is ``t`` the dry run's stand-in (a ``meta`` tensor): the wrapper
    checks it as the card's, returns empty outputs of the kernel's shapes
    and launches nothing."""
    return t.is_meta
