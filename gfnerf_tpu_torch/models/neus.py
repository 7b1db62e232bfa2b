"""NeuS: a surface model on a signed distance field.

Port of ``gfnerf_tpu/models/neus.py`` (the reference's surface-model
family, nerfstudio's ``neus.py`` and ``sdf_field.py``): a
frequency-encoded SDF MLP on top of a sphere prior, a learned sharpness
``s = exp(10 inv_s)``, opacity from NeuS's section alpha (the logistic
CDF's drop across each bin, eq. 13's mid-point estimate), and the SDF's
gradient, taken through the field, for the normals the colour head reads
and the eikonal term.

In the loss the gradient is part of the graph (``torch.autograd.grad``
with ``create_graph``), so the parameters' gradients are of second order,
as the JAX package's ``jax.vmap(jax.grad(...))`` inside the loss makes
them.  Each point's SDF depends on that point alone, so the gradient of
the SDFs' sum is every point's gradient.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from gfnerf_tpu_torch.fields.encodings import nerf_frequency_encode
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.model_components.losses import mse_loss
from gfnerf_tpu_torch.model_components.ray_samplers import spaced_sample
from gfnerf_tpu_torch.model_components.renderers import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
    render_weighted,
)
from gfnerf_tpu_torch.model_components.scene_colliders import sphere_collider
from gfnerf_tpu_torch.models.nerfacto import to_numpy_tree
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class NeuSConfig:
    scene_radius: float = 3.0
    num_samples: int = 96
    pos_frequencies: int = 6
    dir_frequencies: int = 4
    hidden_dim: int = 256
    geo_feat_dim: int = 64
    eikonal_mult: float = 0.1
    background_color: str = "white"
    num_images: int = 1


def init_neus_params(cfg: NeuSConfig, seed: int = 0) -> dict:
    """The SDF MLP, the colour MLP and inv_s = 0.05, numpy, drawn from
    ``default_rng(seed)`` in the JAX package's order."""
    rng = np.random.default_rng(seed)
    pos_dim = 3 * cfg.pos_frequencies * 2 + 3
    dir_dim = 3 * cfg.dir_frequencies * 2 + 3
    return {
        "sdf_mlp": init_mlp(rng, pos_dim, 1 + cfg.geo_feat_dim,
                            cfg.hidden_dim, 3),
        "color_mlp": init_mlp(rng, cfg.geo_feat_dim + dir_dim + 3 + 3, 3,
                              cfg.hidden_dim // 2, 2),
        "inv_s": np.float32(0.05),
    }


class NeuSModel(nn.Module):
    """The SDF and colour MLPs and the sharpness parameter ``inv_s``."""

    def __init__(self, cfg: NeuSConfig, params: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.sdf_mlp = MLP(params["sdf_mlp"], device)
        self.color_mlp = MLP(params["color_mlp"], device)
        self.inv_s = nn.Parameter(torch.tensor(
            np.asarray(params["inv_s"], np.float32), device=device))


def params_from_jax(params, cfg: NeuSConfig, device="cuda") -> NeuSModel:
    """A :class:`NeuSModel` holding the JAX package's params dict."""
    return NeuSModel(cfg, to_numpy_tree(params), device)


def sdf_fn(model: NeuSModel, pos: torch.Tensor):
    """(SDF (...), geometry features (..., G)) at positions (..., 3): the
    unit sphere's ``|p| - 1`` plus 0.1 x the MLP's first output."""
    cfg = model.cfg
    pe = nerf_frequency_encode(pos, cfg.pos_frequencies, 0.0,
                               cfg.pos_frequencies - 1, include_input=True)
    h = apply_mlp(model.sdf_mlp, pe)
    sphere = torch.linalg.norm(pos, dim=-1) - 1.0
    return h[..., 0] * 0.1 + sphere, h[..., 1:]


def neus_alpha(sdf, next_sdf, dists, s):
    """NeuS's section alpha from the SDF at each sample and the next one
    (the mid-point estimate of eq. 13, cosines clipped to facing the
    camera)."""
    mid_sdf = (sdf + next_sdf) * 0.5
    cos_val = (next_sdf - sdf) / torch.clamp(dists, min=1e-6)
    cos_val = torch.clamp(cos_val, -1e3, 0.0)
    est_prev = mid_sdf - cos_val * dists * 0.5
    est_next = mid_sdf + cos_val * dists * 0.5
    cdf_prev = torch.sigmoid(est_prev * s)
    cdf_next = torch.sigmoid(est_next * s)
    return torch.clamp((cdf_prev - cdf_next + 1e-6) / (cdf_prev + 1e-6),
                       0.0, 1.0)


def sdf_and_gradient(model: NeuSModel, pos: torch.Tensor):
    """(SDF (P,), features (P, G), its gradient in the position (P, 3)) at
    positions (P, 3).  Under a recorded graph the gradient is part of it
    (second order); otherwise (eval) all three come without one."""
    graph = torch.is_grad_enabled()
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        sdf, feat = sdf_fn(model, p)
        grad, = torch.autograd.grad(sdf.sum(), p, create_graph=graph)
    if not graph:
        sdf, feat = sdf.detach(), feat.detach()
    return sdf, feat, grad


def neus_forward(model: NeuSModel, rays_o: torch.Tensor,
                 rays_d: torch.Tensor,
                 draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays inside the scene sphere: rgb (R, 3), accumulation
    and depth (R, 1), the rendered normals (R, 3), the weights, the
    eikonal term and the sharpness s.  ``draws``: None (eval), or the
    stratification (R, num_samples + 1), uniform in [0, 1)."""
    cfg = model.cfg
    r = rays_o.shape[0]
    with span("rays"):
        nears, fars = sphere_collider(
            rays_o, rays_d, torch.zeros(3, device=rays_o.device),
            cfg.scene_radius, near_plane=0.05)
        bs, be, _, _ = spaced_sample(nears, fars, cfg.num_samples,
                                     jitter=None if draws is None
                                     else draws[0])
        mid = (bs + be) / 2.0
        pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
        flat = pos.reshape(-1, 3)
    with span("base_mlp"):
        sdf_flat, feat, grad = sdf_and_gradient(model, flat)
        normals = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True)
                          + 1e-6)
    with span("composite"):
        sdf = sdf_flat.reshape(r, -1)
        s = torch.exp(10.0 * model.inv_s)
        next_sdf = torch.cat([sdf[:, 1:], sdf[:, -1:]], dim=1)
        alphas = neus_alpha(sdf, next_sdf, be - bs, s)
        trans = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]),
                                         1.0 - alphas + 1e-7], dim=1),
                              dim=1)[:, :-1]
        weights = alphas * trans
    with span("color_head"):
        de = nerf_frequency_encode(rays_d[:, None, :].expand(pos.shape)
                                   .reshape(-1, 3), cfg.dir_frequencies,
                                   0.0, cfg.dir_frequencies - 1,
                                   include_input=True)
        rgb_s = apply_mlp(model.color_mlp,
                          torch.cat([feat, de, flat, normals], dim=-1),
                          output_activation="sigmoid").reshape(r, -1, 3)
    with span("composite"):
        return {
            "rgb": render_rgb(weights, rgb_s, cfg.background_color),
            "accumulation": render_accumulation(weights),
            "depth": render_expected_depth(weights, mid),
            "normals": render_weighted(weights, normals.reshape(r, -1, 3)),
            "weights": weights,
            "eikonal": torch.mean(
                (torch.linalg.norm(grad, dim=-1) - 1.0) ** 2),
            "s": s,
        }


def neus_loss(model: NeuSModel, rays_o, rays_d, target, draws=None):
    """(total, (losses, outputs)): the MSE and the eikonal term at its
    mult."""
    out = neus_forward(model, rays_o, rays_d, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target),
                  "eikonal_loss": model.cfg.eikonal_mult * out["eikonal"]}
        total = sum(losses.values())
    return total, (losses, out)
