"""Pose orientation and centring, and lens distortion.

Numpy copy of ``gfnerf_tpu/utils/camera_utils.py`` (nerfstudio's
``camera_utils.py``): ``rotation_matrix``, ``focus_of_attention`` and
``auto_orient_and_center_poses`` (methods pca, up, vertical and none;
centring on the poses, on their focus, or not), ``get_distortion_params``,
and the OpenCV radial-tangential undistortion in torch
(:func:`radial_and_tangential_undistort`: ten Newton steps, a
determinant below 1e-12 taken as 1).
"""

from __future__ import annotations

import numpy as np
import torch


def rotation_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (camera_utils.py:404)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        eps = (np.random.rand(3) - 0.5) * 0.01
        return rotation_matrix(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s ** 2 + 1e-8))


def focus_of_attention(poses: np.ndarray, initial: np.ndarray) -> np.ndarray:
    """Closest point to all camera optical axes (camera_utils.py:432-467)."""
    active = np.ones(len(poses), dtype=bool)
    pt = initial.copy()
    for _ in range(10):
        dirs = poses[active, :3, 2:3]  # -z is forward; axis line along z
        oris = poses[active, :3, 3]
        m = np.eye(3)[None] - dirs @ np.transpose(dirs, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        pt = np.linalg.inv(mt_m.sum(0)) @ (mt_m @ oris[..., None]).sum(0)[:, 0]
    return pt


def auto_orient_and_center_poses(
    poses: np.ndarray,  # (N, 4, 4)
    method: str = "up",
    center_method: str = "poses",
):
    """Returns (oriented (N, 3, 4), transform (3, 4)), both f32."""
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(axis=0)
    translation_diff = origins - mean_origin

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(center_method)

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = eigvec[:, ::-1]
        if np.linalg.det(eigvec) < 0:
            eigvec = eigvec.copy()
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec, eigvec @ -translation[:, None]], axis=-1
        )
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            x_axis_matrix = poses[:, :3, 0]
            _, S, Vh = np.linalg.svd(x_axis_matrix, full_matrices=False)
            if S[1] > 0.17 * np.sqrt(poses.shape[0]):
                up_vertical = Vh[2, :]
                up = up_vertical if np.dot(up_vertical, up) > 0 else -up_vertical
            else:
                up = up - Vh[0, :] * np.dot(up, Vh[0, :])
                up = up / np.linalg.norm(up)
        rotation = rotation_matrix(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate(
            [rotation, rotation @ -translation[:, None]], axis=-1
        )
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
        oriented = transform @ poses
    else:
        raise ValueError(method)
    return oriented.astype(np.float32), transform.astype(np.float32)


def get_distortion_params(k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0):
    return np.array([k1, k2, k3, k4, p1, p2], dtype=np.float32)


def radial_and_tangential_undistort(coords: torch.Tensor,
                                    distortion_params: torch.Tensor,
                                    num_iterations: int = 10) -> torch.Tensor:
    """The undistorted normalized image coords (..., 2) of distorted ones,
    under OpenCV's model with (..., 6) params (k1, k2, k3, k4, p1, p2), by
    Newton's method (camera_utils.py:100-133)."""
    k1, k2, k3, k4, p1, p2 = distortion_params.unbind(-1)
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(num_iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - xd
        fy = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y) - yd
        # the distortion model's Jacobian
        d_radial = k1 + r2 * (2 * k2 + r2 * (3 * k3 + r2 * 4 * k4))
        fx_x = radial + x * 2 * x * d_radial + 2 * p1 * y + 6 * p2 * x
        fx_y = x * 2 * y * d_radial + 2 * p1 * x + 2 * p2 * y
        fy_x = y * 2 * x * d_radial + 2 * p2 * y + 2 * p1 * x
        fy_y = radial + y * 2 * y * d_radial + 2 * p2 * x + 6 * p1 * y
        det = fx_x * fy_y - fx_y * fy_x
        det = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
        x = x - (fy_y * fx - fx_y * fy) / det
        y = y - (fx_x * fy - fy_x * fx) / det
    return torch.stack([x, y], dim=-1)
