"""Spatial distortions.

Port of ``gfnerf_tpu/model_components/spatial_distortions.py``
(nerfstudio's ``SceneContraction``, mip-NeRF 360's contraction).
"""

from __future__ import annotations

import math

import torch


def scene_contraction(positions: torch.Tensor,
                      order=math.inf) -> torch.Tensor:
    """Contract R^3 into the ball of radius 2 in the ``order`` norm: x
    where |x| <= 1, else (2 - 1/|x|) x / |x|."""
    if order in (math.inf, "inf"):
        mag = torch.amax(positions.abs(), dim=-1, keepdim=True)
    else:
        mag = torch.linalg.vector_norm(positions, ord=order, dim=-1,
                                       keepdim=True)
    mag = torch.clamp(mag, min=1e-10)
    contracted = (2.0 - 1.0 / mag) * (positions / mag)
    return torch.where(mag <= 1.0, positions, contracted)
