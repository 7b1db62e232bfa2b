"""Instant-NGP: a hash field sampled through an occupancy grid.

Port of ``gfnerf_tpu/models/instant_ngp.py`` (nerfstudio's
``instant_ngp.py`` with nerfacc's occupancy grid):

- a dense occupancy grid (``grid_resolution``^3) over the cube of half
  side ``aabb_scale``, a buffer of :class:`InstantNGPModel`, so that a
  checkpoint holds it; updated by nerfacc's rule, ``occ = max(occ *
  ema_decay, density at a jittered point in each cell)``, with no graph
  (:func:`update_occupancy`);
- sampling: ``num_samples`` stratified samples along each ray between
  its entry into and exit from the box, each kept where its cell's
  occupancy is above ``occ_threshold`` (a fixed-shape mask in place of
  nerfacc's packed march, as in the JAX package);
- the field: the anchored hash encode with one volume, all anchors 0
  (``hash_encode``: H4 forward and H5 table gradient on the card), a base
  MLP giving density (``trunc_exp``) and geometry features, and a colour
  head on SH(direction) and those features; compositing by
  ``get_weights_f2nerf`` and the renderers.

:func:`init_instant_ngp_params` draws the numpy parameters in the JAX
package's order, so one seed gives both packages the same bits.  The
random draws (the samples' stratification, the occupancy jitter) are
tensors the caller passes: the pipeline draws them from its
``torch.Generator``, tests hand over the JAX package's.  Rounding as the
JAX package's jitted step comes out of XLA: a division by a constant is a
multiply by its f32 reciprocal, and the stratification's ``lin + u / (S +
1)`` and the edges' ``near + u * (far - near)`` are fused multiply-adds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf
from gfnerf_tpu_torch.fields.activations import trunc_exp
from gfnerf_tpu_torch.fields.hash_encoding import (_fma, hash_encode,
                                                   init_hash_params)
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4
from gfnerf_tpu_torch.model_components.losses import mse_loss
from gfnerf_tpu_torch.model_components.ray_samplers import _linspace
from gfnerf_tpu_torch.model_components.renderers import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
)
from gfnerf_tpu_torch.model_components.scene_colliders import aabb_collider
from gfnerf_tpu_torch.models.nerfacto import to_numpy_tree
from gfnerf_tpu_torch.utils.profiling import span

# the occupancy grid is updated before the step of every 16th
# (vanilla_pipeline.py:270-273 of the JAX package)
OCC_UPDATE_EVERY = 16


@dataclasses.dataclass
class InstantNGPConfig:
    aabb_scale: float = 1.5
    grid_resolution: int = 96
    num_samples: int = 192
    num_levels: int = 16
    log2_hashmap_size: int = 19
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    occ_ema_decay: float = 0.95
    occ_threshold: float = 0.01
    background_color: str = "white"
    num_images: int = 1


def init_instant_ngp_params(cfg: InstantNGPConfig, seed: int = 0):
    """(params, statics, model_state) as numpy, drawn from
    ``default_rng(seed)`` in the JAX package's order: the table's seed, the
    base MLP, the colour head.  params: feat, base_net, head; statics:
    prim, bias; model_state: occ, all ones."""
    rng = np.random.default_rng(seed)
    feat, prim, bias = init_hash_params(
        seed=int(rng.integers(1 << 31)), log2_table_size=cfg.log2_hashmap_size,
        n_volumes=1, n_levels=cfg.num_levels, init_mode="reset")
    params = {
        "feat": feat,
        "base_net": init_mlp(rng, cfg.num_levels * 2, 1 + cfg.geo_feat_dim,
                             cfg.hidden_dim, 1),
        "head": init_mlp(rng, 16 + cfg.geo_feat_dim, 3, cfg.hidden_dim, 2),
    }
    statics = {"prim": prim, "bias": bias}
    g = cfg.grid_resolution
    model_state = {"occ": np.ones((g, g, g), np.float32)}
    return params, statics, model_state


class InstantNGPModel(nn.Module):
    """The table and the two MLPs as parameters; the hash primes and
    biases and the occupancy grid ``occ`` as buffers."""

    def __init__(self, cfg: InstantNGPConfig, params: dict, statics: dict,
                 model_state: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.feat = nn.Parameter(torch.tensor(
            np.asarray(params["feat"], np.float32), device=device))
        self.base_net = MLP(params["base_net"], device)
        self.head = MLP(params["head"], device)
        self.register_buffer("prim", torch.tensor(
            np.asarray(statics["prim"]).astype(np.int64), device=device))
        self.register_buffer("bias", torch.tensor(
            np.asarray(statics["bias"], np.float32), device=device))
        self.register_buffer("occ", torch.tensor(
            np.asarray(model_state["occ"], np.float32), device=device))


def params_from_jax(params, statics, model_state, cfg: InstantNGPConfig,
                    device="cuda") -> InstantNGPModel:
    """An :class:`InstantNGPModel` holding the JAX package's params,
    statics and model_state dicts, whose leaves convert with
    ``np.asarray``."""
    return InstantNGPModel(cfg, to_numpy_tree(params), to_numpy_tree(statics),
                           to_numpy_tree(model_state), device)


def _aabb(cfg: InstantNGPConfig, device) -> torch.Tensor:
    return torch.tensor([[-cfg.aabb_scale] * 3, [cfg.aabb_scale] * 3],
                        dtype=torch.float32, device=device)


def _unit_coords(pos: torch.Tensor, cfg: InstantNGPConfig) -> torch.Tensor:
    """World positions into the box's [0, 1]: ``(pos - aabb[0]) / (aabb[1]
    - aabb[0])``, the division a multiply by the f32 reciprocal of the
    side."""
    f32 = np.float32
    side = f32(cfg.aabb_scale) - f32(-cfg.aabb_scale)
    return (pos - float(f32(-cfg.aabb_scale))) * float(f32(1.0) / side)


def _density_unit(model: InstantNGPModel, unit: torch.Tensor):
    """Points (..., 3) in the box's [0, 1] -> density (...), geometry
    features (P, G)."""
    p = unit.reshape(-1, 3)
    anc = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    with span("encode"):
        feats = hash_encode(model.feat, model.prim, model.bias, p, anc)
    with span("base_mlp"):
        h = apply_mlp(model.base_net, feats)
        density = trunc_exp(h[..., 0]).reshape(unit.shape[:-1])
    return density, h[..., 1:]


def _density(model: InstantNGPModel, pos: torch.Tensor):
    """World positions (..., 3) -> density (...), geometry features (P,
    G)."""
    return _density_unit(model, _unit_coords(pos, model.cfg))


def occupancy_lookup(model: InstantNGPModel, pos: torch.Tensor
                     ) -> torch.Tensor:
    """The occupancy of the cell holding each world position (...,),
    clamped into the grid."""
    g = model.cfg.grid_resolution
    cell = torch.clamp(_unit_coords(pos, model.cfg) * float(g), 0, g - 1)
    cell = cell.to(torch.int64)
    return model.occ[cell[..., 0], cell[..., 1], cell[..., 2]]


def occupancy_jitter(cfg: InstantNGPConfig, generator: torch.Generator,
                     device) -> torch.Tensor:
    """The occupancy update's uniform draws, (g, g, g, 3)."""
    g = cfg.grid_resolution
    return torch.rand((g, g, g, 3), generator=generator, device=device)


@torch.no_grad()
def update_occupancy(model: InstantNGPModel, jitter: torch.Tensor) -> None:
    """nerfacc's EMA update of the grid, in place: the density at a point
    jittered by ``jitter`` (g, g, g, 3) uniform in [0, 1) inside each
    cell, ``occ = max(occ * occ_ema_decay, density)``."""
    cfg = model.cfg
    g = cfg.grid_resolution
    ii = torch.arange(g, device=model.occ.device)
    grid = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), -1)
    # the JAX package places aabb[0] + (grid + jitter) / g * side and
    # normalizes it back; XLA cancels the round trip into one multiply
    unit = (grid + jitter.to(model.occ.device)) * float(np.float32(1.0)
                                                         / np.float32(g))
    with span("occupancy_update"):   # holds its encode and base MLP spans
        density, _ = _density_unit(model, unit.reshape(-1, 3))
        model.occ.copy_(torch.maximum(model.occ * cfg.occ_ema_decay,
                                      density.reshape(g, g, g)))


def instant_ngp_forward(model: InstantNGPModel, rays_o: torch.Tensor,
                        rays_d: torch.Tensor,
                        draws: Optional[torch.Tensor] = None) -> dict:
    """Render (R,) rays.  ``draws`` (R, S + 1) uniform in [0, 1) jitter
    the sample edges (training); None keeps them even (eval).  Returns rgb
    (R, 3), accumulation and depth (R, 1), the weights (R, S) and the
    share of samples the grid kept, ``keep_frac``."""
    cfg = model.cfg
    s = cfg.num_samples
    with span("rays"):
        nears, fars = aabb_collider(rays_o, rays_d,
                                    _aabb(cfg, rays_o.device),
                                    near_plane=0.02)
        u = _linspace(1.0, s + 1, rays_o.device)
        if draws is not None:
            u = _fma(draws.to(rays_o.device), float(np.float32(1.0 / (s + 1))),
                     u)
        # near + u * (far - near), contracted into a multiply-add
        ts = (u.double() * (fars - nears).double() + nears.double()).float()
        bs, be = ts[:, :-1], ts[:, 1:]
        mid = (bs + be) / 2.0
        pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
    with span("occupancy"):
        keep = occupancy_lookup(model, pos) > cfg.occ_threshold
    density, geo = _density(model, pos)
    density = density * keep
    with span("color_head"):
        d_enc = sh_encode_deg4(rays_d[:, None, :].expand(pos.shape)
                               .reshape(-1, 3))
        rgb_s = apply_mlp(model.head, torch.cat([d_enc, geo], -1),
                          output_activation="sigmoid").reshape(*mid.shape, 3)
    with span("composite"):
        weights = get_weights_f2nerf(be - bs, density)[0]
        rgb = render_rgb(weights, rgb_s, cfg.background_color)
        acc = render_accumulation(weights)
        depth = render_expected_depth(weights, mid)
    return {"rgb": rgb, "accumulation": acc, "depth": depth,
            "weights": weights,
            "keep_frac": torch.mean(keep.to(torch.float32))}


def instant_ngp_loss(model: InstantNGPModel, rays_o, rays_d, target,
                     draws=None):
    """(total, (losses, outputs)): the MSE of the colour."""
    out = instant_ngp_forward(model, rays_o, rays_d, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target)}
        total = sum(losses.values())
    return total, (losses, out)
