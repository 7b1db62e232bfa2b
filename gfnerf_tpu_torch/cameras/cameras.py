"""Camera models and ray generation in PyTorch.

Port of ``gfnerf_tpu/cameras/cameras.py``: perspective cameras with
optional OpenCV radial-tangential distortion, equidistant fisheye and
equirectangular cameras.  Convention (nerfstudio / the reference C++,
OpenGL-style): perspective camera-space ray directions are ``[(x -
cx)/fx, -(y - cy)/fy, -1]`` rotated by the camera-to-world rotation.

As in the JAX package, only :func:`generate_rays_multi` (the train
batches) undistorts; :func:`generate_rays` (one camera, the eval and
render path) does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.utils.camera_utils import (
    radial_and_tangential_undistort,
)

CAMERA_TYPE_PERSPECTIVE = 0
CAMERA_TYPE_FISHEYE = 1
CAMERA_TYPE_EQUIRECTANGULAR = 2


@dataclasses.dataclass
class Cameras:
    """A batch of cameras of one type, SoA layout. Leading dim N."""

    camera_to_worlds: torch.Tensor  # (N, 3, 4) f32
    fx: torch.Tensor                # (N,)
    fy: torch.Tensor                # (N,)
    cx: torch.Tensor                # (N,)
    cy: torch.Tensor                # (N,)
    width: torch.Tensor             # (N,) int32
    height: torch.Tensor            # (N,) int32
    # (N, 6) k1 k2 k3 k4 p1 p2, or None
    distortion_params: Optional[torch.Tensor] = None
    camera_type: int = CAMERA_TYPE_PERSPECTIVE

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    @classmethod
    def from_numpy(cls, c2w, fx, fy, cx, cy, width, height,
                   device="cuda", distortion_params=None,
                   camera_type: int = CAMERA_TYPE_PERSPECTIVE) -> "Cameras":
        n = len(c2w)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i32(x):
            return torch.as_tensor(
                np.broadcast_to(np.asarray(x, np.int32), (n,)).copy(),
                device=device)

        return cls(f32(c2w), f32(fx), f32(fy), f32(cx), f32(cy),
                   i32(width), i32(height),
                   None if distortion_params is None
                   else f32(distortion_params), int(camera_type))


def camera_ray_directions(coords: torch.Tensor, fx, fy, cx, cy,
                          camera_type: int = CAMERA_TYPE_PERSPECTIVE,
                          width=None, height=None):
    """Camera-space (un-normalized) direction for pixel coords (y, x):
    perspective, equidistant fisheye (r = f theta) or equirectangular
    (longitude across the width, latitude down the height)."""
    y = coords[..., 0]
    x = coords[..., 1]
    if camera_type == CAMERA_TYPE_PERSPECTIVE:
        return torch.stack([(x - cx) / fx, -(y - cy) / fy,
                            -torch.ones_like(x)], dim=-1)
    if camera_type == CAMERA_TYPE_FISHEYE:
        u = (x - cx) / fx
        v = -(y - cy) / fy
        theta = torch.clamp(torch.sqrt(u * u + v * v), 1e-9, np.pi)
        sin_over = torch.sin(theta) / theta
        return torch.stack([u * sin_over, v * sin_over, -torch.cos(theta)],
                           dim=-1)
    if camera_type == CAMERA_TYPE_EQUIRECTANGULAR:
        lon = (x / width - 0.5) * 2.0 * np.pi
        lat = -(y / height - 0.5) * np.pi
        return torch.stack([torch.sin(lon) * torch.cos(lat), torch.sin(lat),
                            -torch.cos(lon) * torch.cos(lat)], dim=-1)
    raise ValueError(camera_type)


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
    wh = (cameras.camera_type, cameras.width[camera_index],
          cameras.height[camera_index])
    rot_t = c2w[:3, :3].T

    def world_unit(pix):
        return _unit(camera_ray_directions(pix, fx, fy, cx, cy, *wh) @ rot_t)

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
    """Rays across per-ray camera indices (R,) at pixel coords (R, 2).
    Perspective cameras with distortion parameters are undistorted
    (reference cameras.py:446-462); the pixel area comes from the
    distorted neighbours, as in the JAX package."""
    c2w = cameras.camera_to_worlds[camera_indices]     # (R, 3, 4)
    fx, fy = cameras.fx[camera_indices], cameras.fy[camera_indices]
    cx, cy = cameras.cx[camera_indices], cameras.cy[camera_indices]
    ct = cameras.camera_type
    wh = (ct, cameras.width[camera_indices], cameras.height[camera_indices])
    rot = c2w[:, :3, :3]

    def world_unit(d):
        return _unit(torch.einsum("rij,rj->ri", rot, d))

    d_cam = camera_ray_directions(coords, fx, fy, cx, cy, *wh)
    if ct == CAMERA_TYPE_PERSPECTIVE and cameras.distortion_params is not None:
        und = radial_and_tangential_undistort(
            torch.stack([d_cam[..., 0], -d_cam[..., 1]], -1),
            cameras.distortion_params[camera_indices])
        d_cam = torch.stack([und[..., 0], -und[..., 1],
                             -torch.ones_like(und[..., 0])], dim=-1)
    d_world = world_unit(d_cam)
    d_dx = world_unit(camera_ray_directions(
        coords + coords.new_tensor([0.0, 1.0]), fx, fy, cx, cy, *wh))
    d_dy = world_unit(camera_ray_directions(
        coords + coords.new_tensor([1.0, 0.0]), fx, fy, cx, cy, *wh))
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
