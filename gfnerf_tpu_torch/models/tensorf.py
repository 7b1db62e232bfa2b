"""TensoRF with the vector-matrix (VM) decomposition.

Port of ``gfnerf_tpu/models/tensorf.py`` (nerfstudio's ``tensorf.py`` and
``tensorf_field.py``): three feature planes (xy, xz, yz), each paired
with a feature line (z, y, x); a field value is the channel-wise product
of a plane's bilinear lookup and its line's linear one, the three pairs
concatenated.  The density is the softplus of the density factors' sum;
the colour a small MLP on the appearance factors (through a linear basis)
and SH(direction).  Rays are cut to the scene box (``aabb_collider``),
sampled evenly, then resampled by the coarse weights with the coarse edges
kept (``pdf_sample(..., include_original=True)``).  The loss adds an L1
penalty on the density factors.

:class:`TensoRFModel` holds the planes and lines as ``nn.ParameterList``s,
so the state dict names them ``den_planes.0`` .. ``app_lines.2``, the JAX
package's list structure; every plane and line is a leaf of the optimizer.
Rounding as the JAX package's jitted step comes out of XLA: the division
by the box's side is a multiply by its f32 reciprocal, before the floor
of the plane and line lookups.  The lookups are ``index_select``s, whose
backward is a scatter-add: the backward of indexing (``plane[idx]``)
sorts the indices first, and with a million lookups into a 128^2 plane
it took 482 ms of a 518 ms step on an H100.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4
from gfnerf_tpu_torch.model_components.losses import mse_loss
from gfnerf_tpu_torch.model_components.ray_samplers import (pdf_sample,
                                                           spaced_sample)
from gfnerf_tpu_torch.model_components.renderers import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
)
from gfnerf_tpu_torch.model_components.scene_colliders import aabb_collider
from gfnerf_tpu_torch.models.nerfacto import to_numpy_tree
from gfnerf_tpu_torch.utils.profiling import span

PLANE_AXES = ((0, 1), (0, 2), (1, 2))   # matrix factors
LINE_AXES = (2, 1, 0)                   # paired vector factors


@dataclasses.dataclass
class TensoRFConfig:
    aabb_scale: float = 1.5
    resolution: int = 128
    density_channels: int = 16
    appearance_channels: int = 24
    appearance_dim: int = 27
    num_coarse_samples: int = 128
    num_fine_samples: int = 64
    hidden_dim: int = 128
    background_color: str = "white"
    l1_mult: float = 5e-4
    num_images: int = 1


def init_tensorf_params(cfg: TensoRFConfig, seed: int = 0) -> dict:
    """The planes (res, res, C), lines (res, C), the appearance basis and
    the colour head, numpy f32, drawn from ``default_rng(seed)`` in the
    JAX package's order."""
    rng = np.random.default_rng(seed)
    r = cfg.resolution

    def planes(c):
        return [(0.1 * rng.standard_normal((r, r, c))).astype(np.float32)
                for _ in range(3)]

    def lines(c):
        return [(0.1 * rng.standard_normal((r, c))).astype(np.float32)
                for _ in range(3)]

    return {
        "den_planes": planes(cfg.density_channels),
        "den_lines": lines(cfg.density_channels),
        "app_planes": planes(cfg.appearance_channels),
        "app_lines": lines(cfg.appearance_channels),
        "basis": (0.1 * rng.standard_normal(
            (3 * cfg.appearance_channels, cfg.appearance_dim))
        ).astype(np.float32),
        "head": init_mlp(rng, cfg.appearance_dim + 16, 3, cfg.hidden_dim, 2),
    }


class TensoRFModel(nn.Module):
    """The VM factors, the appearance basis and the colour head."""

    def __init__(self, cfg: TensoRFConfig, params: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg

        def plist(xs):
            return nn.ParameterList([nn.Parameter(torch.tensor(
                np.asarray(x, np.float32), device=device)) for x in xs])

        self.den_planes = plist(params["den_planes"])
        self.den_lines = plist(params["den_lines"])
        self.app_planes = plist(params["app_planes"])
        self.app_lines = plist(params["app_lines"])
        self.basis = nn.Parameter(torch.tensor(
            np.asarray(params["basis"], np.float32), device=device))
        self.head = MLP(params["head"], device)


def params_from_jax(params, cfg: TensoRFConfig,
                    device="cuda") -> TensoRFModel:
    """A :class:`TensoRFModel` holding the JAX package's params dict."""
    return TensoRFModel(cfg, to_numpy_tree(params), device)


def _bilinear_plane(plane: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """plane (res, res, C) at u, v (N,) in [0, 1]: (N, C)."""
    r = plane.shape[0]
    x = torch.clamp(u * (r - 1), 0, r - 1)
    y = torch.clamp(v * (r - 1), 0, r - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=r - 1)
    y1 = torch.clamp(y0 + 1, max=r - 1)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    p = plane.reshape(r * r, -1)
    f00, f01 = p.index_select(0, x0 * r + y0), p.index_select(0, x0 * r + y1)
    f10, f11 = p.index_select(0, x1 * r + y0), p.index_select(0, x1 * r + y1)
    return (f00 * (1 - fx) * (1 - fy) + f01 * (1 - fx) * fy
            + f10 * fx * (1 - fy) + f11 * fx * fy)


def _linear_line(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """line (res, C) at t (N,) in [0, 1]: (N, C)."""
    r = line.shape[0]
    x = torch.clamp(t * (r - 1), 0, r - 1)
    x0f = torch.floor(x)
    x0 = x0f.long()
    x1 = torch.clamp(x0 + 1, max=r - 1)
    f = (x - x0f)[:, None]
    return line.index_select(0, x0) * (1 - f) + line.index_select(0, x1) * f


def _vm_features(planes, lines, p: torch.Tensor) -> torch.Tensor:
    """The VM factors' products at p (N, 3) in [0, 1]: (N, 3 C)."""
    feats = []
    for (a0, a1), la, plane, line in zip(PLANE_AXES, LINE_AXES, planes,
                                         lines):
        feats.append(_bilinear_plane(plane, p[:, a0], p[:, a1])
                     * _linear_line(line, p[:, la]))
    return torch.cat(feats, dim=-1)


def _aabb(cfg: TensoRFConfig, device) -> torch.Tensor:
    return torch.tensor([[-cfg.aabb_scale] * 3, [cfg.aabb_scale] * 3],
                        dtype=torch.float32, device=device)


def _unit_coords(pos: torch.Tensor, cfg: TensoRFConfig) -> torch.Tensor:
    """World positions into the box's [0, 1], clipped: ``(pos - aabb[0]) /
    (aabb[1] - aabb[0])``, the division a multiply by the f32 reciprocal
    of the side."""
    f32 = np.float32
    side = f32(cfg.aabb_scale) - f32(-cfg.aabb_scale)
    p = (pos - float(f32(-cfg.aabb_scale))) * float(f32(1.0) / side)
    return torch.clamp(p, 0.0, 1.0)


def tensorf_density(model: TensoRFModel, pos: torch.Tensor):
    """(density (...), the unit coordinates (P, 3)) at world positions
    (..., 3)."""
    p = _unit_coords(pos.reshape(-1, 3), model.cfg)
    f = _vm_features(model.den_planes, model.den_lines, p)
    density = F.softplus(torch.sum(f, dim=-1) - 1.0)
    return density.reshape(pos.shape[:-1]), p


def tensorf_forward(model: TensoRFModel, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays: rgb (R, 3), accumulation and depth (R, 1), the
    fine weights.  ``draws``: None (eval), or the coarse stratification
    (R, n_coarse + 1) and the resampling's (R, n_fine + 1), uniform in [0,
    1)."""
    cfg = model.cfg
    r = rays_o.shape[0]
    with span("rays"):
        nears, fars = aabb_collider(rays_o, rays_d,
                                    _aabb(cfg, rays_o.device),
                                    near_plane=0.05)
        bs, be, ss, se = spaced_sample(
            nears, fars, cfg.num_coarse_samples,
            jitter=None if draws is None else draws[0])
        mid = (bs + be) / 2.0
        pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
    with span("encode"):
        density, _ = tensorf_density(model, pos)
    with span("rays"):
        w_coarse = get_weights_f2nerf(be - bs, density)[0]
        ss2, se2 = pdf_sample(ss, se, w_coarse, cfg.num_fine_samples,
                              None if draws is None else draws[1],
                              include_original=True)
        bs2 = ss2 * fars + (1 - ss2) * nears
        be2 = se2 * fars + (1 - se2) * nears
        mid2 = (bs2 + be2) / 2.0
        pos2 = rays_o[:, None, :] + mid2[..., None] * rays_d[:, None, :]
    with span("encode"):
        density2, p2 = tensorf_density(model, pos2)
        app = _vm_features(model.app_planes, model.app_lines, p2)
    with span("color_head"):
        app = app @ model.basis
        d_enc = sh_encode_deg4(rays_d[:, None, :].expand(pos2.shape)
                               .reshape(-1, 3))
        rgb_s = apply_mlp(model.head, torch.cat([app, d_enc], -1),
                          output_activation="sigmoid").reshape(r, -1, 3)
    with span("composite"):
        w = get_weights_f2nerf(be2 - bs2, density2)[0]
        return {"rgb": render_rgb(w, rgb_s, cfg.background_color),
                "accumulation": render_accumulation(w),
                "depth": render_expected_depth(w, mid2), "weights": w}


def tensorf_loss(model: TensoRFModel, rays_o, rays_d, target, draws=None):
    """(total, (losses, outputs)): the MSE and the L1 penalty on the
    density factors (each factor's mean absolute value)."""
    out = tensorf_forward(model, rays_o, rays_d, draws)
    with span("loss"):
        l1 = sum(torch.mean(torch.abs(x)) for x in model.den_planes)
        l1 = l1 + sum(torch.mean(torch.abs(x)) for x in model.den_lines)
        losses = {"rgb_loss": mse_loss(out["rgb"], target),
                  "l1_reg": model.cfg.l1_mult * l1}
        total = sum(losses.values())
    return total, (losses, out)
