"""PyTorch/CUDA port of the Evolved Sampling trainer.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never JAX and nothing of ``repro``. Entry points take
an explicit ``device`` whose default is ``"cuda"``; the CPU runs only when
a caller asks for it. Hand-written CUDA kernels (``csrc/``) carry the ES
scoring forward and the score update; the plain PyTorch version of each
sits beside its wrapper under ``kernels/``.
"""
