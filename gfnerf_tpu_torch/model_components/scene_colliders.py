"""Scene colliders: per-ray near and far bounds.

Port of ``gfnerf_tpu/model_components/scene_colliders.py`` (nerfstudio's
``NearFarCollider``, ``AABBBoxCollider`` and ``SphereCollider``).
"""

from __future__ import annotations

import torch


def near_far_collider(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      near_plane: float, far_plane: float):
    """(nears, fars), each (R, 1), the same planes for every ray."""
    r = rays_o.shape[0]
    return (rays_o.new_full((r, 1), near_plane),
            rays_o.new_full((r, 1), far_plane))


def aabb_collider(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  aabb: torch.Tensor, near_plane: float = 0.0):
    """(nears, fars) (R, 1) of each ray's entry into and exit from the box
    ``aabb`` (2, 3) [min; max]; near at least ``near_plane``, far at least
    near + 1e-6."""
    inv = 1.0 / torch.where(rays_d.abs() < 1e-10,
                            torch.full_like(rays_d, 1e-10), rays_d)
    t0 = (aabb[0][None] - rays_o) * inv
    t1 = (aabb[1][None] - rays_o) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    far = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    near = torch.clamp(near, min=near_plane)
    return near, torch.maximum(far, near + 1e-6)


def sphere_collider(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    center: torch.Tensor, radius: float,
                    near_plane: float = 0.0):
    """(nears, fars) (R, 1) of each ray's entry into and exit from the
    sphere (unit directions); a ray that misses gets its closest
    approach."""
    oc = rays_o - center[None]
    b = torch.sum(oc * rays_d, dim=-1, keepdim=True)
    c = torch.sum(oc * oc, dim=-1, keepdim=True) - radius ** 2
    sq = torch.sqrt(torch.clamp(b * b - c, min=0.0))
    near = torch.clamp(-b - sq, min=near_plane)
    return near, torch.maximum(-b + sq, near + 1e-6)
