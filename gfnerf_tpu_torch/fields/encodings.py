"""Coordinate encodings of the stock model families.

Port of ``gfnerf_tpu/fields/encodings.py`` (nerfstudio's
``field_components/encodings.py``): the NeRF frequency encoding (:79-130)
and random Fourier features (:133-170), with the numpy draw of their
matrix.  The hash encodings live in ``hash_encoding.py`` and
``packed_hash.py``, the SH encoding in ``sh_encoding.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gfnerf_tpu_torch.model_components.ray_samplers import _linspace


def nerf_frequency_encode(x: torch.Tensor, num_frequencies: int = 10,
                          min_freq_exp: float = 0.0,
                          max_freq_exp: float = 8.0,
                          include_input: bool = False) -> torch.Tensor:
    """NeRF's sin/cos encoding of x (..., D): (..., D * num_frequencies * 2
    [+ D]), per coordinate its F sines then its F cosines (as sines of the
    argument plus pi / 2).  The exponents are ``linspace(min, max, F)``,
    rounded as XLA folds the JAX package's ``jnp.linspace``."""
    exps = _linspace(max_freq_exp - min_freq_exp, num_frequencies,
                     x.device)[0]
    if min_freq_exp != 0.0:
        exps = exps + float(np.float32(min_freq_exp))
    freqs = torch.pow(2.0, exps)
    scaled = 2.0 * math.pi * x[..., None] * freqs          # (..., D, F)
    enc = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def rff_encode(x: torch.Tensor, b_matrix: torch.Tensor) -> torch.Tensor:
    """Random Fourier features of x (..., D) under a fixed Gaussian
    b_matrix (D, F): (..., 2F), the sines then the cosines."""
    scaled = 2.0 * math.pi * x @ b_matrix
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def init_rff_matrix(rng: np.random.Generator, in_dim: int, num_freqs: int,
                    scale: float = 10.0) -> np.ndarray:
    """The (in_dim, num_freqs) f32 Gaussian matrix times ``scale``, drawn
    from the numpy generator as the JAX package draws it."""
    return rng.standard_normal((in_dim, num_freqs)).astype(
        np.float32) * np.float32(scale)
