"""PyTorch + CUDA port of the GF-NeRF render path.

Mirrors ``gfnerf_tpu``'s module paths and function names.  Imports ``torch``
and numpy only; the hand-written CUDA kernels live in ``csrc/`` and are built
on first use by :mod:`gfnerf_tpu_torch.ops.build`.
"""
