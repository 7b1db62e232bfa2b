"""NeRFPlayer: the nerfacto and instant-ngp pipelines on temporal grids.

Port of ``gfnerf_tpu/models/nerfplayer.py`` (nerfstudio's
``nerfplayer_nerfacto.py`` and ``nerfplayer_ngp.py``):

- ``nerfplayer-nerfacto``: nerfacto's proposal sampler, contraction,
  losses and colour head (with the per-image appearance embedding), every
  hash table replaced by a time-conditioned temporal grid
  (``fields/temporal_grid.py``: T1 forward and T2 table gradient on the
  card), plus the temporal TV regularizer on each grid;
- ``nerfplayer-ngp``: a temporal field sampled at ``num_samples`` jittered
  stratified points between fixed near and far planes, each kept where
  the occupancy grid (``grid_resolution``^3 over the cube of half side
  ``aabb_scale``, a buffer of the model, so a checkpoint holds it) is
  above ``occ_threshold``; the grid's EMA ``occ = max(0.95 occ, density)``
  is taken at a jittered point in each cell at a random time
  (:func:`update_ngp_occupancy`), so that a cell empty at one time and
  full at another is kept.

Each ray's time is its camera's, ``camera_times[rel]`` (a buffer: the
dataparser's ``metadata["times"]``, zeros without them).  Eval and render
pass ``rel = 0`` for every ray, as the JAX package's pipeline does: camera
0's time and appearance.  :func:`init_nerfplayer_params` and
:func:`init_nerfplayer_ngp_params` draw the numpy parameters in the JAX
package's order.  The random draws are tensors the caller passes: the
proposal sampler's (``proposal_sample``), the ngp stratification (R, S),
the occupancy update's jitter and times, and the TV regularizer's window
rows (one per grid: the JAX package draws them from one key with each
grid's row count, :func:`tv_rows` from one uniform).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf
from gfnerf_tpu_torch.fields.activations import trunc_exp
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4
from gfnerf_tpu_torch.fields.temporal_grid import (make_temporal_grid,
                                                   temporal_grid_encode,
                                                   temporal_tv_loss)
from gfnerf_tpu_torch.model_components.losses import mse_loss
from gfnerf_tpu_torch.model_components.ray_samplers import proposal_sample
from gfnerf_tpu_torch.model_components.renderers import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
)
from gfnerf_tpu_torch.model_components.scene_colliders import near_far_collider
from gfnerf_tpu_torch.models.nerfacto import (normalize_positions,
                                              proposal_losses, to_numpy_tree)
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class NerfplayerConfig:
    near_plane: float = 0.05
    far_plane: float = 1000.0
    temporal_dim: int = 64
    num_levels: int = 16
    base_resolution: int = 16
    desired_resolution: int = 2048
    level_dim: int = 2
    log2_hashmap_size: int = 19
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    geo_feat_dim: int = 15
    appearance_embedding_dim: int = 32
    num_proposal_samples: Tuple[int, ...] = (256, 96)
    num_nerf_samples: int = 48
    prop_temporal_dim: int = 32
    prop_num_levels: int = 5
    prop_log2_hashmap_size: int = 17
    prop_max_res: Tuple[int, ...] = (64, 256)
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    temporal_tv_weight: float = 1.0
    background_color: str = "last_sample"
    use_scene_contraction: bool = True
    num_images: int = 1


@dataclasses.dataclass
class NerfplayerNGPConfig:
    aabb_scale: float = 1.5
    grid_resolution: int = 64
    num_samples: int = 192
    temporal_dim: int = 64
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    desired_resolution: int = 1024
    log2_hashmap_size: int = 19
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    hidden_dim_color: int = 64
    temporal_tv_weight: float = 1.0
    background_color: str = "white"
    occ_threshold: float = 1e-2
    num_images: int = 1


# the grid's EMA decay (nerfplayer_ngp.py's occupancy grid)
OCC_DECAY = 0.95


def _camera_times(cfg, camera_times) -> np.ndarray:
    if camera_times is None:
        return np.zeros((cfg.num_images,), np.float32)
    return np.asarray(camera_times, np.float32)


def init_nerfplayer_params(cfg: NerfplayerConfig, seed: int = 0,
                           camera_times: Optional[np.ndarray] = None):
    """(params, statics) as numpy, drawn from ``default_rng(seed)`` in the
    JAX package's order: the field grid's seed; each proposal grid's seed
    and MLP; the base MLP, the colour head, the appearance embedding.
    params: field_emb, prop_embs, prop_mlps, base_net, mlp_head,
    appearance; statics: field_st, prop_sts, camera_times."""
    rng = np.random.default_rng(seed)
    field_emb, field_st = make_temporal_grid(
        seed=int(rng.integers(1 << 31)), temporal_dim=cfg.temporal_dim,
        num_levels=cfg.num_levels, level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=cfg.desired_resolution)
    prop_embs, prop_sts, prop_mlps = [], [], []
    for i in range(len(cfg.num_proposal_samples)):
        emb, st = make_temporal_grid(
            seed=int(rng.integers(1 << 31)),
            temporal_dim=cfg.prop_temporal_dim,
            num_levels=cfg.prop_num_levels, level_dim=cfg.level_dim,
            base_resolution=cfg.base_resolution,
            log2_hashmap_size=cfg.prop_log2_hashmap_size,
            desired_resolution=cfg.prop_max_res[
                min(i, len(cfg.prop_max_res) - 1)])
        prop_embs.append(emb)
        prop_sts.append(st)
        prop_mlps.append(init_mlp(
            rng, cfg.prop_num_levels * cfg.level_dim, 1, 16, 1))
    base_net = init_mlp(rng, cfg.num_levels * cfg.level_dim,
                        1 + cfg.geo_feat_dim, cfg.hidden_dim, 1)
    head = init_mlp(rng, 16 + cfg.geo_feat_dim + cfg.appearance_embedding_dim,
                    3, cfg.hidden_dim_color, 2)
    appearance = rng.standard_normal(
        (cfg.num_images, cfg.appearance_embedding_dim)).astype(np.float32)
    params = {"field_emb": field_emb, "prop_embs": prop_embs,
              "prop_mlps": prop_mlps, "base_net": base_net,
              "mlp_head": head, "appearance": appearance}
    statics = {"field_st": field_st, "prop_sts": prop_sts,
               "camera_times": _camera_times(cfg, camera_times)}
    return params, statics


def init_nerfplayer_ngp_params(cfg: NerfplayerNGPConfig, seed: int = 0,
                               camera_times: Optional[np.ndarray] = None):
    """(params, statics, model_state) as numpy in the JAX package's order:
    the grid's seed, the base MLP, the colour head.  model_state: occ, all
    ones."""
    rng = np.random.default_rng(seed)
    emb, st = make_temporal_grid(
        seed=int(rng.integers(1 << 31)), temporal_dim=cfg.temporal_dim,
        num_levels=cfg.num_levels, level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=cfg.desired_resolution)
    base_net = init_mlp(rng, cfg.num_levels * cfg.level_dim,
                        1 + cfg.geo_feat_dim, cfg.hidden_dim, 1)
    head = init_mlp(rng, 16 + cfg.geo_feat_dim, 3, cfg.hidden_dim_color, 2)
    params = {"field_emb": emb, "base_net": base_net, "mlp_head": head}
    statics = {"field_st": st,
               "camera_times": _camera_times(cfg, camera_times)}
    g = cfg.grid_resolution
    model_state = {"occ": np.ones((g, g, g), np.float32)}
    return params, statics, model_state


def _param(x, device):
    return nn.Parameter(torch.tensor(np.asarray(x, np.float32),
                                     device=device))


class NerfplayerModel(nn.Module):
    """nerfplayer-nerfacto's grids, MLPs and appearance embedding as
    parameters, the cameras' times as a buffer; the grids' statics (numpy)
    as attributes."""

    def __init__(self, cfg: NerfplayerConfig, params: dict, statics: dict,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.field_emb = _param(params["field_emb"], device)
        self.prop_embs = nn.ParameterList(
            [_param(t, device) for t in params["prop_embs"]])
        self.prop_mlps = nn.ModuleList(
            [MLP(m, device) for m in params["prop_mlps"]])
        self.base_net = MLP(params["base_net"], device)
        self.mlp_head = MLP(params["mlp_head"], device)
        self.appearance = _param(params["appearance"], device)
        self.field_st = statics["field_st"]
        self.prop_sts = list(statics["prop_sts"])
        self.register_buffer("camera_times", torch.tensor(
            np.asarray(statics["camera_times"], np.float32), device=device))

    def grids(self) -> list:
        """(table, statics) of every grid: the field's, then the
        proposals'."""
        return [(self.field_emb, self.field_st),
                *zip(self.prop_embs, self.prop_sts)]


class NerfplayerNGPModel(nn.Module):
    """nerfplayer-ngp's grid and MLPs as parameters; the cameras' times and
    the occupancy grid ``occ`` as buffers."""

    def __init__(self, cfg: NerfplayerNGPConfig, params: dict, statics: dict,
                 model_state: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.field_emb = _param(params["field_emb"], device)
        self.base_net = MLP(params["base_net"], device)
        self.mlp_head = MLP(params["mlp_head"], device)
        self.field_st = statics["field_st"]
        self.register_buffer("camera_times", torch.tensor(
            np.asarray(statics["camera_times"], np.float32), device=device))
        self.register_buffer("occ", torch.tensor(
            np.asarray(model_state["occ"], np.float32), device=device))

    def grids(self) -> list:
        return [(self.field_emb, self.field_st)]


def _statics_tree(statics: dict) -> dict:
    """The JAX package's statics with the camera times as numpy (the grid
    statics are the port's dataclass, built from the JAX one's arrays)."""
    from gfnerf_tpu_torch.fields.temporal_grid import TemporalGridStatics

    def grid(st):
        return TemporalGridStatics(**{
            f.name: getattr(st, f.name) for f in dataclasses.fields(st)})

    out = {"camera_times": np.asarray(statics["camera_times"], np.float32),
           "field_st": grid(statics["field_st"])}
    if "prop_sts" in statics:
        out["prop_sts"] = [grid(st) for st in statics["prop_sts"]]
    return out


def params_from_jax(params, statics, model_state, cfg,
                    device="cuda") -> nn.Module:
    """The port's model holding the JAX package's params, statics and (for
    nerfplayer-ngp) model_state, whose leaves convert with ``np.asarray``:
    a :class:`NerfplayerModel` for a :class:`NerfplayerConfig` (pass
    ``model_state=None``), a :class:`NerfplayerNGPModel` for a
    :class:`NerfplayerNGPConfig`."""
    p, s = to_numpy_tree(params), _statics_tree(statics)
    if isinstance(cfg, NerfplayerNGPConfig):
        return NerfplayerNGPModel(cfg, p, s, to_numpy_tree(model_state),
                                  device)
    return NerfplayerModel(cfg, p, s, device)


def tv_rows(model: nn.Module, generator: torch.Generator,
            device) -> torch.Tensor:
    """The TV regularizer's window rows, one per grid (field first), from
    one uniform draw: ``floor(u * rows)`` of each grid's row count."""
    u = torch.rand((1,), generator=generator, device=device)
    return torch.cat([torch.clamp((u * st.n_rows).long(), max=st.n_rows - 1)
                      for _, st in model.grids()])


def temporal_tv(model: nn.Module, rows: torch.Tensor) -> torch.Tensor:
    """The sum over the grids (field first) of the TV regularizer at each
    grid's row."""
    tv = 0.0
    for i, (emb, st) in enumerate(model.grids()):
        tv = tv + temporal_tv_loss(emb, st, rows[i])
    return tv


def _encode(emb, st, unit: torch.Tensor, times: torch.Tensor):
    """The encode (P, L * C) of unit positions (..., 3), each at its time
    (...)."""
    return temporal_grid_encode(emb, st, unit.reshape(-1, 3),
                                times.reshape(-1))


def _ray_times(times: torch.Tensor, shape) -> torch.Tensor:
    """Each ray's time (R,) broadcast to its samples ``shape`` (R, S)."""
    return times[:, None].expand(shape).contiguous()


# ------------------------------------------------------ nerfplayer-nerfacto ----


def proposal_density_fn(model: NerfplayerModel, level: int,
                        times: torch.Tensor):
    """Proposal level ``level``'s density at the rays' times: positions
    (R, S, 3) -> (R, S)."""

    def fn(pos):
        with span("proposal"):
            feats = _encode(model.prop_embs[level], model.prop_sts[level],
                            normalize_positions(pos, model.cfg),
                            _ray_times(times, pos.shape[:-1]))
            h = apply_mlp(model.prop_mlps[level], feats)
            return trunc_exp(h[..., 0]).reshape(pos.shape[:-1])

    return fn


def nerfplayer_forward(model: NerfplayerModel, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, rel_camera_indices: torch.Tensor,
                       draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays at their cameras' times: the proposal sampler's
    levels, then the field on ``num_nerf_samples`` samples a ray.
    ``draws``: the proposal sampler's uniform draws (None in eval).
    Returns rgb (R, 3), accumulation and depth (R, 1), the final weights
    (R, S), the final normalized bins and each proposal level's weights and
    bins."""
    cfg = model.cfg
    r = rays_o.shape[0]
    times = model.camera_times[rel_camera_indices]
    nears, fars = near_far_collider(rays_o, rays_d, cfg.near_plane,
                                    cfg.far_plane)
    out = proposal_sample(
        nears, fars,
        [proposal_density_fn(model, i, times)
         for i in range(len(cfg.num_proposal_samples))],
        rays_o, rays_d, num_proposal_samples=cfg.num_proposal_samples,
        num_nerf_samples=cfg.num_nerf_samples, draws=draws)
    bs, be = out["bin_starts"], out["bin_ends"]
    mid = (bs + be) / 2.0
    pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
    with span("encode"):
        feats = _encode(model.field_emb, model.field_st,
                        normalize_positions(pos, cfg),
                        _ray_times(times, mid.shape))
    with span("base_mlp"):
        h = apply_mlp(model.base_net, feats)
        density = trunc_exp(h[..., 0]).reshape(r, -1)
        geo = h[..., 1:]
    with span("color_head"):
        d_enc = sh_encode_deg4(rays_d[:, None, :].expand(pos.shape)
                               .reshape(-1, 3))
        emb = model.appearance[rel_camera_indices[:, None].expand(mid.shape)
                               .reshape(-1)]
        rgb_s = apply_mlp(model.mlp_head, torch.cat([d_enc, geo, emb], -1),
                          output_activation="sigmoid").reshape(r, -1, 3)
    with span("composite"):
        weights = get_weights_f2nerf(be - bs, density)[0]
        rgb = render_rgb(weights, rgb_s, cfg.background_color)
        acc = render_accumulation(weights)
        depth = render_expected_depth(weights, mid)
    return {
        "rgb": rgb, "accumulation": acc, "depth": depth, "weights": weights,
        "spacing_starts": out["spacing_starts"],
        "spacing_ends": out["spacing_ends"],
        "weights_list": out["weights_list"],
        "spacing_list": out["spacing_list"],
    }


def _tv_term(model, rows, losses) -> None:
    if model.cfg.temporal_tv_weight > 0:
        if rows is None:
            raise ValueError("the temporal TV term needs each grid's window "
                             "row (tv_rows)")
        with span("temporal_tv"):
            losses["temporal_tv_loss"] = (model.cfg.temporal_tv_weight
                                          * temporal_tv(model, rows))


def nerfplayer_loss(model: NerfplayerModel, rays_o, rays_d, rel, target,
                    draws=None, rows: Optional[torch.Tensor] = None):
    """(total, (losses, outputs)): MSE, interlevel, distortion and the
    temporal TV term at the grids' window ``rows`` (field first)."""
    out = nerfplayer_forward(model, rays_o, rays_d, rel, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target),
                  **proposal_losses(model.cfg, out)}
    _tv_term(model, rows, losses)
    total = sum(losses.values())
    return total, (losses, out)


# ----------------------------------------------------------- nerfplayer-ngp ----


def _ngp_unit(pos: torch.Tensor, cfg: NerfplayerNGPConfig) -> torch.Tensor:
    """World positions into the grid's [0, 1]: ``pos / (2 aabb) + 0.5``."""
    return pos / (2 * cfg.aabb_scale) + 0.5


def _ngp_density(model: NerfplayerNGPModel, pos: torch.Tensor,
                 times: torch.Tensor):
    """World positions (..., 3) at times (...) -> density (...), geometry
    features (P, G)."""
    unit = torch.clamp(_ngp_unit(pos, model.cfg), 0.0, 1.0)
    with span("encode"):
        feats = _encode(model.field_emb, model.field_st, unit, times)
    with span("base_mlp"):
        h = apply_mlp(model.base_net, feats)
        density = trunc_exp(h[..., 0]).reshape(pos.shape[:-1])
    return density, h[..., 1:]


def occupancy_draws(cfg: NerfplayerNGPConfig, generator: torch.Generator,
                    device) -> List[torch.Tensor]:
    """The occupancy update's draws: the jitter (g^3, 3) and the times
    (g^3,), uniform in [0, 1)."""
    n = cfg.grid_resolution ** 3
    return [torch.rand((n, 3), generator=generator, device=device),
            torch.rand((n,), generator=generator, device=device)]


@torch.no_grad()
def update_ngp_occupancy(model: NerfplayerNGPModel, jitter: torch.Tensor,
                         times: torch.Tensor) -> None:
    """The grid's EMA, in place: the density at a point jittered by
    ``jitter`` (g^3, 3) inside each cell (cells in C order), at
    ``times`` (g^3,): ``occ = max(0.95 occ, density)``."""
    cfg = model.cfg
    g = cfg.grid_resolution
    ii = torch.arange(g, device=model.occ.device)
    grid = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"),
                       -1).reshape(-1, 3)
    pos = ((grid + jitter.to(model.occ.device)) * (2 * cfg.aabb_scale / g)
           - cfg.aabb_scale)
    with span("occupancy_update"):   # holds its encode and base MLP spans
        density, _ = _ngp_density(model, pos, times.to(model.occ.device))
        model.occ.copy_(torch.maximum(model.occ * OCC_DECAY,
                                      density.reshape(g, g, g)))


def occupancy_lookup(model: NerfplayerNGPModel,
                     pos: torch.Tensor) -> torch.Tensor:
    """The occupancy of the cell holding each world position (...),
    clamped into the grid."""
    g = model.cfg.grid_resolution
    cell = torch.clamp((_ngp_unit(pos, model.cfg) * g).to(torch.int64), 0,
                       g - 1)
    return model.occ[cell[..., 0], cell[..., 1], cell[..., 2]]


def nerfplayer_ngp_forward(model: NerfplayerNGPModel, rays_o: torch.Tensor,
                           rays_d: torch.Tensor,
                           rel_camera_indices: torch.Tensor,
                           draws: Optional[torch.Tensor] = None) -> dict:
    """Render (R,) rays at their cameras' times.  ``draws`` (R, S) uniform
    in [0, 1) jitter the samples (training); None keeps them at their
    strata's middles (eval).  Returns rgb (R, 3), accumulation and depth
    (R, 1) and the weights (R, S)."""
    cfg = model.cfg
    s = cfg.num_samples
    times = model.camera_times[rel_camera_indices]
    with span("rays"):
        nears, fars = near_far_collider(rays_o, rays_d, 0.05,
                                        2 * 1.7321 * cfg.aabb_scale)
        u = (torch.arange(s, dtype=torch.float32, device=rays_o.device)
             + 0.5) / s
        if draws is not None:
            u = u + (draws.to(rays_o.device) - 0.5) / s
        ts = nears + (fars - nears) * u
        pos = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    with span("occupancy"):
        keep = occupancy_lookup(model, pos) > cfg.occ_threshold
    density, geo = _ngp_density(model, pos, _ray_times(times, ts.shape))
    density = density * keep
    with span("color_head"):
        d_enc = sh_encode_deg4(rays_d[:, None, :].expand(pos.shape)
                               .reshape(-1, 3))
        rgb_s = apply_mlp(model.mlp_head, torch.cat([d_enc, geo], -1),
                          output_activation="sigmoid").reshape(*ts.shape, 3)
    with span("composite"):
        dt = ((fars - nears) / s).expand(ts.shape)
        weights = get_weights_f2nerf(dt, density)[0]
        rgb = render_rgb(weights, rgb_s, cfg.background_color)
        acc = render_accumulation(weights)
        depth = render_expected_depth(weights, ts)
    return {"rgb": rgb, "accumulation": acc, "depth": depth,
            "weights": weights}


def nerfplayer_ngp_loss(model: NerfplayerNGPModel, rays_o, rays_d, rel,
                        target, draws=None,
                        rows: Optional[torch.Tensor] = None):
    """(total, (losses, outputs)): MSE and the temporal TV term at the
    grid's window row ``rows[0]``."""
    out = nerfplayer_ngp_forward(model, rays_o, rays_d, rel, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target)}
    _tv_term(model, rows, losses)
    total = sum(losses.values())
    return total, (losses, out)
