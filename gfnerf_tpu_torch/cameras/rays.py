"""Sample containers and compositing weights.

Port of ``gfnerf_tpu/cameras/rays.py``: ``WarpedSamples`` (fixed-shape
(R, S) samples with a validity mask; ``warp_pts`` is filled by the scan
march and left None by the fast march, which leaves the warp to the model)
and ``get_weights_f2nerf``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class WarpedSamples:
    """Perspective-warped sample data emitted by the octree marcher."""

    world_pts: torch.Tensor     # (R, S, 3) sample positions, world space
    dists: torch.Tensor         # (R, S) warp-space step along the ray
    ts: torch.Tensor            # (R, S) distance along the ray
    # the three indices are int32 after the scan march (as the JAX
    # package's), int64 after the fast march
    trans_idx: torch.Tensor     # (R, S) warp/volume anchor (-1 invalid)
    oct_idx: torch.Tensor       # (R, S) octree node (-1 invalid)
    block_idx: torch.Tensor     # (R, S) focal block (-1 unassigned)
    valid: torch.Tensor         # (R, S) bool
    num_valid: torch.Tensor     # (R,) int64
    first_oct_dis: torch.Tensor  # (R,) t of the first octree hit (1e9 if none)
    num_hits: Optional[torch.Tensor] = None  # (R,) leaf hits before top-k
    warp_pts: Optional[torch.Tensor] = None  # (R, S, 3) warped (scan march)


def get_weights_f2nerf(deltas: torch.Tensor, densities: torch.Tensor):
    """(weights, alphas, transmittance) from (R, S) deltas and densities,
    with an exclusive cumulative optical depth (rays.py:178-200)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cumsum(delta_density, dim=-1)
    accum = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]],
                      dim=-1)
    transmittance = torch.exp(-accum)
    weights = torch.nan_to_num(alphas * transmittance)
    return weights, alphas, transmittance
