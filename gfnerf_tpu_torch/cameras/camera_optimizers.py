"""Camera pose optimization.

Port of ``gfnerf_tpu/cameras/camera_optimizers.py`` (nerfstudio's
``camera_optimizers.py`` and ``lie_groups.py``): a learnable (num_cameras,
6) tangent per camera, (translation, rotation), zero at the start, whose
exponential is composed with each generated ray (``apply_to_rays``), and
its L2 penalty (``pose_regularization``).  Modes "off", "SO3xR3" (a
rotation and an independent translation) and "SE3" (a screw motion).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CameraOptimizerConfig:
    mode: str = "off"            # "off" | "SO3xR3" | "SE3"
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3


def init_pose_adjustment(num_cameras: int, device="cuda") -> torch.Tensor:
    """(num_cameras, 6) zero tangents."""
    return torch.zeros((num_cameras, 6), dtype=torch.float32, device=device)


def _hat(omega: torch.Tensor) -> torch.Tensor:
    """The skew matrix (..., 3, 3) of omega (..., 3)."""
    wx, wy, wz = omega.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], -1),
        torch.stack([wz, zeros, -wx], -1),
        torch.stack([-wy, wx, zeros], -1),
    ], -2)


def _theta(omega: torch.Tensor):
    """(theta^2 (..., 1, 1), small (..., 1, 1), theta at a safe argument:
    1 where theta^2 < 1e-10).  The singular forms are evaluated only at
    the safe argument, so that their gradient is finite at exactly zero
    tangents, where every tangent starts (the JAX package's
    camera_optimizers.py:33-52)."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return theta_sq, small, safe_sq, torch.sqrt(safe_sq)


def exp_map_so3(omega: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) by Rodrigues' formula: omega (..., 3) -> (..., 3,
    3), its small-angle series below theta^2 = 1e-10."""
    theta_sq, small, safe_sq, theta = _theta(omega)
    k = _hat(omega)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1 - torch.cos(theta)) / safe_sq)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * k + b * (k @ k)


def exp_map_se3(tangent: torch.Tensor):
    """se(3) -> SE(3): tangent (..., 6) = (v, omega).  Returns (R (..., 3,
    3), t (..., 3))."""
    v, omega = tangent[..., :3], tangent[..., 3:]
    rot = exp_map_so3(omega)
    theta_sq, small, safe_sq, theta = _theta(omega)
    k = _hat(omega)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1 - torch.cos(theta)) / safe_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    vmat = eye + b * k + c * (k @ k)
    return rot, (vmat @ v[..., None])[..., 0]


def apply_to_rays(cfg: CameraOptimizerConfig, adjustment: torch.Tensor,
                  camera_indices: torch.Tensor, origins: torch.Tensor,
                  directions: torch.Tensor):
    """Each ray (R, 3) moved by its camera's pose delta: ``R o + t`` and
    ``R d``.  "off" returns the rays as they are."""
    if cfg.mode == "off":
        return origins, directions
    tang = adjustment[camera_indices]               # (R, 6)
    if cfg.mode == "SO3xR3":
        rot, t = exp_map_so3(tang[..., 3:]), tang[..., :3]
    elif cfg.mode == "SE3":
        rot, t = exp_map_se3(tang)
    else:
        raise ValueError(f"unknown camera optimizer mode {cfg.mode!r}")
    new_o = (rot @ origins[..., None])[..., 0] + t
    new_d = (rot @ directions[..., None])[..., 0]
    return new_o, new_d


def pose_regularization(cfg: CameraOptimizerConfig,
                        adjustment: torch.Tensor) -> torch.Tensor:
    """The tangents' weighted squared norm, translation and rotation
    apart."""
    if cfg.mode == "off":
        return adjustment.new_zeros(())
    return (cfg.trans_l2_penalty * torch.sum(adjustment[:, :3] ** 2)
            + cfg.rot_l2_penalty * torch.sum(adjustment[:, 3:] ** 2))
