"""Hand-written CUDA kernels of the port, one folder each.

Each folder holds ``ops.py`` (the wrapper: checks, launch, launch count)
and ``ref.py`` (the plain PyTorch version of the same function). The CUDA
sources live in ``repro_torch/csrc`` and are built by ``_build.py`` at
first use. Counterparts of the Pallas kernels in ``repro/kernels``.
"""
