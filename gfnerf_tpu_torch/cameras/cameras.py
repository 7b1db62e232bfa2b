"""Pinhole camera model and ray generation in PyTorch.

Port of ``gfnerf_tpu/cameras/cameras.py`` (perspective cameras; the
distortion and fisheye/equirectangular models are not ported yet).
Convention (nerfstudio / the reference C++, OpenGL-style): camera-space ray
directions are ``[(x - cx)/fx, -(y - cy)/fy, -1]`` rotated by the
camera-to-world rotation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Cameras:
    """A batch of perspective cameras, SoA layout. Leading dim N."""

    camera_to_worlds: torch.Tensor  # (N, 3, 4) f32
    fx: torch.Tensor                # (N,)
    fy: torch.Tensor                # (N,)
    cx: torch.Tensor                # (N,)
    cy: torch.Tensor                # (N,)
    width: torch.Tensor             # (N,) int32
    height: torch.Tensor            # (N,) int32

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    @classmethod
    def from_numpy(cls, c2w, fx, fy, cx, cy, width, height,
                   device="cuda") -> "Cameras":
        n = len(c2w)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i32(x):
            return torch.as_tensor(
                np.broadcast_to(np.asarray(x, np.int32), (n,)).copy(),
                device=device)

        return cls(f32(c2w), f32(fx), f32(fy), f32(cx), f32(cy),
                   i32(width), i32(height))


def camera_ray_directions(coords: torch.Tensor, fx, fy, cx, cy):
    """Camera-space (un-normalized) direction for pixel coords (y, x)."""
    y = coords[..., 0]
    x = coords[..., 1]
    return torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)],
                       dim=-1)


def _unit(w: torch.Tensor) -> torch.Tensor:
    return w / torch.linalg.norm(w, dim=-1, keepdim=True)


def generate_rays(cameras: Cameras, camera_index: int, coords: torch.Tensor):
    """World-space rays for one camera at pixel coords (..., 2) as (y, x).

    Returns a dict with origins, directions (unit), pixel_area and
    lookat_directions, shaped like ``coords[..., 0]``.
    """
    c2w = cameras.camera_to_worlds[camera_index]
    fx, fy = cameras.fx[camera_index], cameras.fy[camera_index]
    cx, cy = cameras.cx[camera_index], cameras.cy[camera_index]
    rot_t = c2w[:3, :3].T

    def world_unit(pix):
        return _unit(camera_ray_directions(pix, fx, fy, cx, cy) @ rot_t)

    d_world = world_unit(coords)
    d_dx = world_unit(coords + coords.new_tensor([0.0, 1.0]))
    d_dy = world_unit(coords + coords.new_tensor([1.0, 0.0]))
    dx = torch.linalg.norm(d_dx - d_world, dim=-1)
    dy = torch.linalg.norm(d_dy - d_world, dim=-1)
    return {
        "origins": c2w[:3, 3].expand(d_world.shape),
        "directions": d_world,
        "pixel_area": (dx * dy)[..., None],
        "lookat_directions": c2w[:3, 2].expand(d_world.shape),
    }


def generate_rays_multi(cameras: Cameras, camera_indices: torch.Tensor,
                        coords: torch.Tensor):
    """Rays across per-ray camera indices (R,) at pixel coords (R, 2)."""
    c2w = cameras.camera_to_worlds[camera_indices]     # (R, 3, 4)
    fx, fy = cameras.fx[camera_indices], cameras.fy[camera_indices]
    cx, cy = cameras.cx[camera_indices], cameras.cy[camera_indices]
    rot = c2w[:, :3, :3]

    def world_unit(pix):
        d = camera_ray_directions(pix, fx, fy, cx, cy)
        return _unit(torch.einsum("rij,rj->ri", rot, d))

    d_world = world_unit(coords)
    d_dx = world_unit(coords + coords.new_tensor([0.0, 1.0]))
    d_dy = world_unit(coords + coords.new_tensor([1.0, 0.0]))
    dx = torch.linalg.norm(d_dx - d_world, dim=-1)
    dy = torch.linalg.norm(d_dy - d_world, dim=-1)
    return {
        "origins": c2w[:, :3, 3],
        "directions": d_world,
        "pixel_area": (dx * dy)[..., None],
        "lookat_directions": c2w[:, :3, 2],
    }


def get_image_coords(height: int, width: int,
                     pixel_offset: float = 0.5) -> np.ndarray:
    """(H, W, 2) grid of (y, x) pixel-centre coords."""
    yy, xx = np.meshgrid(
        np.arange(height, dtype=np.float32) + pixel_offset,
        np.arange(width, dtype=np.float32) + pixel_offset,
        indexing="ij",
    )
    return np.stack([yy, xx], axis=-1)
