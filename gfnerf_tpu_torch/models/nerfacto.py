"""Nerfacto: the proposal sampler and a hash field under scene contraction.

Port of the nerfacto part of ``gfnerf_tpu/models/nerfacto.py``
(nerfstudio's ``nerfacto.py``, the SURVEY's baseline model): per ray, a
near/far collider; two proposal density fields (each a 5-level hash table
and a 16-wide MLP) that importance-resample the samples level by level
(``proposal_sample``); the main field (a 16-level hash table, a base MLP
giving density and geometry features, a colour head on SH(direction),
the geometry features and a per-image appearance embedding) on the final
samples; compositing by ``get_weights_f2nerf`` and the renderers.  Every
position goes through mip-NeRF 360's contraction (order inf) and into [0,
1] as ``(contract(x) + 2) / 4``, and every hash encode is the anchored
layout's with one volume and all anchors 0 (``hash_encode``: H4 forward
and H5 table gradient on the card), as the JAX package's
``hash_encode_sorted`` calls are.

:func:`init_nerfacto_params` draws the numpy parameters in the JAX
package's order, so that one seed gives both packages the same bits;
:class:`NerfactoModel` holds them as ``nn.Parameter``s (the hash primes and
biases as buffers).  The losses are nerfacto's (MSE, interlevel, distortion)
and depth-nerfacto's DS-NeRF depth term.

The second half of the JAX module, vanilla NeRF and mip-NeRF: vanilla
NeRF's coarse and fine frequency-encoded MLPs between fixed near and far
planes (the fine pass resamples by the coarse weights and keeps the coarse
edges, ``pdf_sample(..., include_original=True)``); mip-NeRF's integrated
positional encoding over each bin's conical frustum, one shared MLP for
both levels, its cones' radius from the rays' pixel area.  Their random
draws are tensors the caller passes (the stratification, then the
resampling), as nerfacto's are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf
from gfnerf_tpu_torch.fields.activations import trunc_exp
from gfnerf_tpu_torch.fields.encodings import nerf_frequency_encode
from gfnerf_tpu_torch.fields.hash_encoding import (_fma, hash_encode,
                                                   init_hash_params)
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4
from gfnerf_tpu_torch.model_components.losses import (
    distortion_loss,
    ds_nerf_depth_loss,
    interlevel_loss,
    mse_loss,
)
from gfnerf_tpu_torch.model_components.ray_samplers import (pdf_sample,
                                                           proposal_sample,
                                                           spaced_sample)
from gfnerf_tpu_torch.model_components.renderers import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
)
from gfnerf_tpu_torch.model_components.scene_colliders import near_far_collider
from gfnerf_tpu_torch.model_components.spatial_distortions import (
    scene_contraction,
)
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class NerfactoConfig:
    near_plane: float = 0.05
    far_plane: float = 1000.0
    num_levels: int = 16
    log2_hashmap_size: int = 19
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    geo_feat_dim: int = 15
    appearance_embedding_dim: int = 32
    num_proposal_samples: Tuple[int, ...] = (256, 96)
    num_nerf_samples: int = 48
    proposal_log2_hashmap_size: int = 17
    proposal_num_levels: int = 5
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    background_color: str = "last_sample"
    use_scene_contraction: bool = True
    num_images: int = 1


@dataclasses.dataclass
class VanillaNerfConfig:
    """Vanilla NeRF's settings."""

    near_plane: float = 2.0
    far_plane: float = 6.0
    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    pos_frequencies: int = 10
    dir_frequencies: int = 4
    hidden_dim: int = 256
    background_color: str = "white"


@dataclasses.dataclass
class MipNerfConfig:
    """Mip-NeRF's settings."""

    near_plane: float = 2.0
    far_plane: float = 6.0
    num_coarse_samples: int = 128
    num_importance_samples: int = 128
    num_frequencies: int = 16
    dir_frequencies: int = 4
    hidden_dim: int = 256
    background_color: str = "white"


def init_nerfacto_params(cfg: NerfactoConfig, seed: int = 0):
    """(params, statics) as numpy, drawn from ``default_rng(seed)`` in the
    JAX package's order: the field table's seed; each proposal level's
    table seed and MLP; the base MLP, the colour head, the appearance
    embedding.  params: field_feat, prop_feats, prop_mlps, base_net,
    mlp_head, appearance; statics: field_prim, field_bias, prop_prims,
    prop_biases."""
    rng = np.random.default_rng(seed)

    def table(log2_size, n_levels):
        return init_hash_params(seed=int(rng.integers(1 << 31)),
                                log2_table_size=log2_size, n_volumes=1,
                                n_levels=n_levels, init_mode="reset")

    field = table(cfg.log2_hashmap_size, cfg.num_levels)
    props = []
    for _ in cfg.num_proposal_samples:
        t = table(cfg.proposal_log2_hashmap_size, cfg.proposal_num_levels)
        props.append((t, init_mlp(rng, cfg.proposal_num_levels * 2, 1, 16,
                                  1)))
    base_net = init_mlp(rng, cfg.num_levels * 2, 1 + cfg.geo_feat_dim,
                        cfg.hidden_dim, 1)
    head = init_mlp(rng, 16 + cfg.geo_feat_dim + cfg.appearance_embedding_dim,
                    3, cfg.hidden_dim_color, 2)
    appearance = rng.standard_normal(
        (cfg.num_images, cfg.appearance_embedding_dim)).astype(np.float32)
    params = {"field_feat": field[0], "prop_feats": [t[0] for t, _ in props],
              "prop_mlps": [m for _, m in props], "base_net": base_net,
              "mlp_head": head, "appearance": appearance}
    statics = {"field_prim": field[1], "field_bias": field[2],
               "prop_prims": [t[1] for t, _ in props],
               "prop_biases": [t[2] for t, _ in props]}
    return params, statics


class NerfactoModel(nn.Module):
    """Nerfacto's parameters (and, for semantic-nerfw, the semantics heads
    ``mlp_semantics`` and ``semantics_head``, where ``params`` has them)."""

    def __init__(self, cfg: NerfactoConfig, params: dict, statics: dict,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg

        def param(x):
            return nn.Parameter(torch.tensor(np.asarray(x, np.float32),
                                             device=device))

        def buf(x, dtype):
            return torch.tensor(np.asarray(x).astype(dtype), device=device)

        self.field_feat = param(params["field_feat"])
        self.prop_feats = nn.ParameterList(
            [param(t) for t in params["prop_feats"]])
        self.prop_mlps = nn.ModuleList(
            [MLP(m, device) for m in params["prop_mlps"]])
        self.base_net = MLP(params["base_net"], device)
        self.mlp_head = MLP(params["mlp_head"], device)
        self.appearance = param(params["appearance"])
        self.mlp_semantics = (MLP(params["mlp_semantics"], device)
                              if "mlp_semantics" in params else None)
        self.semantics_head = (MLP(params["semantics_head"], device)
                               if "semantics_head" in params else None)
        self.register_buffer("field_prim", buf(statics["field_prim"],
                                               np.int64))
        self.register_buffer("field_bias", buf(statics["field_bias"],
                                               np.float32))
        for i, (prim, bias) in enumerate(zip(statics["prop_prims"],
                                             statics["prop_biases"])):
            self.register_buffer(f"prop_prim_{i}", buf(prim, np.int64))
            self.register_buffer(f"prop_bias_{i}", buf(bias, np.float32))

    def prop_table(self, level: int):
        """(table, primes, biases) of proposal level ``level``."""
        return (self.prop_feats[level], getattr(self, f"prop_prim_{level}"),
                getattr(self, f"prop_bias_{level}"))


def to_numpy_tree(x):
    """A JAX package's params tree (dicts and lists of arrays) with every
    leaf as a numpy array."""
    if isinstance(x, dict):
        return {k: to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy_tree(v) for v in x]
    return np.asarray(x)


def nerfacto_params_from_jax(params, statics, cfg: NerfactoConfig,
                             device="cuda") -> NerfactoModel:
    """A :class:`NerfactoModel` holding the JAX package's nerfacto (or
    semantic-nerfw) params and statics dicts, whose leaves convert with
    ``np.asarray``."""
    return NerfactoModel(cfg, to_numpy_tree(params), to_numpy_tree(statics),
                         device)


def normalize_positions(pos: torch.Tensor,
                        cfg: NerfactoConfig) -> torch.Tensor:
    """Positions (..., 3) into the hash's [0, 1]: ``(contract(x) + 2) /
    4`` (the division by 4 is exact); far points land on 1.0 exactly."""
    if cfg.use_scene_contraction:
        pos = scene_contraction(pos)
    return (pos + 2.0) / 4.0


def _encode(table, prim, bias, pos: torch.Tensor,
            cfg: NerfactoConfig) -> torch.Tensor:
    """The anchored encode (P, 2L) of positions (..., 3): one volume, all
    anchors 0."""
    p = normalize_positions(pos, cfg).reshape(-1, 3)
    anc = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    return hash_encode(table, prim, bias, p, anc)


def proposal_density_fn(model: NerfactoModel, level: int):
    """Proposal level ``level``'s density: positions (R, S, 3) -> (R,
    S)."""

    def fn(pos):
        with span("proposal"):
            feats = _encode(*model.prop_table(level), pos, model.cfg)
            h = apply_mlp(model.prop_mlps[level], feats)
            return trunc_exp(h[..., 0]).reshape(pos.shape[:-1])

    return fn


def nerfacto_forward(model: NerfactoModel, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, rel_camera_indices: torch.Tensor,
                     draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays: the proposal sampler's levels, then the field on
    ``num_nerf_samples`` samples a ray.  ``draws``: the proposal sampler's
    uniform draws (``proposal_sample``; None in eval).  Returns rgb (R, 3),
    accumulation and depth (R, 1), the final weights (R, S), the geometry
    features (R, S, G), the final normalized bins (spacing_starts,
    spacing_ends) and each proposal level's weights and bins
    (weights_list, spacing_list)."""
    cfg = model.cfg
    r = rays_o.shape[0]
    nears, fars = near_far_collider(rays_o, rays_d, cfg.near_plane,
                                    cfg.far_plane)
    out = proposal_sample(
        nears, fars,
        [proposal_density_fn(model, i)
         for i in range(len(cfg.num_proposal_samples))],
        rays_o, rays_d, num_proposal_samples=cfg.num_proposal_samples,
        num_nerf_samples=cfg.num_nerf_samples, draws=draws)
    bs, be = out["bin_starts"], out["bin_ends"]
    mid = (bs + be) / 2.0
    pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
    with span("encode"):
        feats = _encode(model.field_feat, model.field_prim, model.field_bias,
                        pos, cfg)
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
        "geo": geo.reshape(r, -1, cfg.geo_feat_dim),
        "spacing_starts": out["spacing_starts"],
        "spacing_ends": out["spacing_ends"],
        "weights_list": out["weights_list"],
        "spacing_list": out["spacing_list"],
    }


def proposal_losses(cfg: NerfactoConfig, out: dict) -> dict:
    """The interlevel loss summed over the proposal levels (its gradient
    reaches each level's weights, so it trains the proposal fields) and
    the distortion loss on the final weights, each at its mult."""
    il = 0.0
    for ws, (ss, se) in zip(out["weights_list"], out["spacing_list"]):
        il = il + interlevel_loss(out["weights"], out["spacing_starts"],
                                  out["spacing_ends"], ws, ss, se)
    return {"interlevel_loss": cfg.interlevel_loss_mult * il,
            "distortion_loss": cfg.distortion_loss_mult * distortion_loss(
                out["weights"], out["spacing_starts"], out["spacing_ends"])}


def nerfacto_loss(model: NerfactoModel, rays_o, rays_d, rel, target,
                  draws=None):
    """(total, (losses, outputs)): MSE, interlevel and distortion."""
    out = nerfacto_forward(model, rays_o, rays_d, rel, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target),
                  **proposal_losses(model.cfg, out)}
        total = sum(losses.values())
    return total, (losses, out)


def depth_nerfacto_loss(model: NerfactoModel, rays_o, rays_d, rel, target,
                        depth_gt: Optional[torch.Tensor] = None,
                        depth_loss_mult: float = 1e-3, draws=None):
    """Depth-nerfacto (nerfstudio's ``depth_nerfacto.py``): nerfacto's
    losses and, given ground-truth depths ``depth_gt`` (R, 1), the DS-NeRF
    depth term on the final normalized bins' midpoints and lengths."""
    total, (losses, out) = nerfacto_loss(model, rays_o, rays_d, rel, target,
                                         draws)
    if depth_gt is not None:
        mid = (out["spacing_starts"] + out["spacing_ends"]) / 2.0
        lengths = out["spacing_ends"] - out["spacing_starts"]
        losses["depth_loss"] = depth_loss_mult * ds_nerf_depth_loss(
            out["weights"], depth_gt, mid, lengths)
        total = total + losses["depth_loss"]
    return total, (losses, out)


# ------------------------------------------------------------ vanilla NeRF ----


class NerfMLPs(nn.Module):
    """One NeRF field's three MLPs: ``mlp1`` (the encoded position to a
    hidden code), ``mlp2`` (the code and the encoding again to density and
    features), ``head`` (the features and the encoded direction to
    colour)."""

    def __init__(self, params: dict, device="cuda"):
        super().__init__()
        self.mlp1 = MLP(params["mlp1"], device)
        self.mlp2 = MLP(params["mlp2"], device)
        self.head = MLP(params["head"], device)


def _nerf_mlps_params(rng: np.random.Generator, pos_dim: int, dir_dim: int,
                      hidden: int) -> dict:
    return {"mlp1": init_mlp(rng, pos_dim, hidden, hidden, 3),
            "mlp2": init_mlp(rng, hidden + pos_dim, hidden + 1, hidden, 3),
            "head": init_mlp(rng, hidden + dir_dim, 3, hidden // 2, 0)}


def init_vanilla_params(cfg: VanillaNerfConfig, seed: int = 0) -> dict:
    """{"coarse": ..., "fine": ...}, each {mlp1, mlp2, head}, numpy, drawn
    from ``default_rng(seed)`` in the JAX package's order."""
    rng = np.random.default_rng(seed)
    pos_dim = 3 * cfg.pos_frequencies * 2 + 3
    dir_dim = 3 * cfg.dir_frequencies * 2 + 3
    return {level: _nerf_mlps_params(rng, pos_dim, dir_dim, cfg.hidden_dim)
            for level in ("coarse", "fine")}


class VanillaNerfModel(nn.Module):
    """Vanilla NeRF: the coarse and the fine field."""

    def __init__(self, cfg: VanillaNerfConfig, params: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.coarse = NerfMLPs(params["coarse"], device)
        self.fine = NerfMLPs(params["fine"], device)


def vanilla_params_from_jax(params, cfg: VanillaNerfConfig,
                            device="cuda") -> VanillaNerfModel:
    """A :class:`VanillaNerfModel` holding the JAX package's params."""
    return VanillaNerfModel(cfg, to_numpy_tree(params), device)


def _vanilla_field(mlps: NerfMLPs, cfg: VanillaNerfConfig, pos, dirs):
    """Density (P,) and colour (P, 3) at positions and directions (P,
    3)."""
    pe = nerf_frequency_encode(pos, cfg.pos_frequencies, 0.0,
                               cfg.pos_frequencies - 1, include_input=True)
    de = nerf_frequency_encode(dirs, cfg.dir_frequencies, 0.0,
                               cfg.dir_frequencies - 1, include_input=True)
    h = torch.relu(apply_mlp(mlps.mlp1, pe))
    h2 = apply_mlp(mlps.mlp2, torch.cat([h, pe], -1))
    density = torch.relu(h2[..., 0])
    feat = torch.relu(h2[..., 1:])
    rgb = apply_mlp(mlps.head, torch.cat([feat, de], -1),
                    output_activation="sigmoid")
    return density, rgb


def _render_level(w, rgb_s, mid, background: str) -> dict:
    return {"rgb": render_rgb(w, rgb_s, background),
            "accumulation": render_accumulation(w),
            "depth": render_expected_depth(w, mid), "weights": w}


def _draw(draws, i):
    return None if draws is None else draws[i]


def vanilla_forward(model: VanillaNerfModel, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays between the near and far planes: {"coarse": ...,
    "fine": ...}, each rgb (R, 3), accumulation and depth (R, 1), weights.
    ``draws``: None (eval: even coarse bins, each fine edge at its
    stratum's middle), or the coarse stratification (R, n_coarse + 1) and
    the fine resampling's (R, n_importance + 1), uniform in [0, 1)."""
    cfg = model.cfg
    r = rays_o.shape[0]
    nears, fars = near_far_collider(rays_o, rays_d, cfg.near_plane,
                                    cfg.far_plane)
    outs = {}
    with span("rays"):
        bs, be, ss, se = spaced_sample(nears, fars, cfg.num_coarse_samples,
                                       jitter=_draw(draws, 0))
    for level in ("coarse", "fine"):
        with span("rays"):
            if level == "fine":
                ss, se = pdf_sample(ss, se, outs["coarse"]["weights"],
                                    cfg.num_importance_samples,
                                    _draw(draws, 1), include_original=True)
                bs = ss * fars + (1 - ss) * nears
                be = se * fars + (1 - se) * nears
            mid = (bs + be) / 2.0
            # o + t d as one multiply-add, as XLA compiles the JAX
            # package's: the encoding's 2^9 multiplies an ulp here
            pos = _fma(mid[..., None], rays_d[:, None, :],
                       rays_o[:, None, :])
            dirs = rays_d[:, None, :].expand(pos.shape)
        with span("base_mlp"):
            density, rgb_s = _vanilla_field(getattr(model, level), cfg,
                                            pos.reshape(-1, 3),
                                            dirs.reshape(-1, 3))
        with span("composite"):
            w = get_weights_f2nerf(be - bs, density.reshape(r, -1))[0]
            outs[level] = _render_level(w, rgb_s.reshape(r, -1, 3), mid,
                                        cfg.background_color)
    return outs


def vanilla_loss(model: VanillaNerfModel, rays_o, rays_d, target,
                 draws=None):
    """(total, (losses, outputs)): the coarse and the fine MSE."""
    outs = vanilla_forward(model, rays_o, rays_d, draws)
    with span("loss"):
        losses = {"rgb_loss_coarse": mse_loss(outs["coarse"]["rgb"], target),
                  "rgb_loss_fine": mse_loss(outs["fine"]["rgb"], target)}
        total = sum(losses.values())
    return total, (losses, outs)


# ------------------------------------------------------------------ mipnerf ----


def integrated_pos_enc(means: torch.Tensor, covs_diag: torch.Tensor,
                       num_frequencies: int) -> torch.Tensor:
    """mip-NeRF's integrated positional encoding of Gaussians (means and
    diagonal covariances (..., 3)): E[sin(2^j x)] = sin(2^j mu) exp(-0.5
    4^j sigma^2), and the cosines likewise; (..., 6 F), per frequency the
    three sines then the three cosines."""
    freqs = torch.pow(2.0, torch.arange(num_frequencies, dtype=torch.float32,
                                        device=means.device))
    scaled = means[..., None, :] * freqs[:, None]             # (..., F, 3)
    var = covs_diag[..., None, :] * (freqs[:, None] ** 2)
    damp = torch.exp(-0.5 * var)
    enc = torch.cat([torch.sin(scaled) * damp, torch.cos(scaled) * damp],
                    dim=-1)
    return enc.reshape(*means.shape[:-1], -1)


def conical_frustum_gaussian(rays_o, rays_d, starts, ends, radius):
    """The mean and diagonal covariance (R, S, 3) of each bin's conical
    frustum (mip-NeRF section 3.1), radius (R,) the cone's at unit
    distance."""
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    common = hw ** 2 / torch.clamp(3 * mu ** 2 + hw ** 2, min=1e-10)
    t_mean = mu + 2 * mu * common
    t_var = hw ** 2 / 3 - (4 / 15) * (hw ** 4 * (12 * mu ** 2 - hw ** 2)
                                      / torch.clamp((3 * mu ** 2 + hw ** 2)
                                                    ** 2, min=1e-10))
    r_var = radius[..., None] ** 2 * (
        mu ** 2 / 4 + (5 / 12) * hw ** 2
        - (4 / 15) * hw ** 4 / torch.clamp(3 * mu ** 2 + hw ** 2, min=1e-10))
    means = rays_o[:, None, :] + t_mean[..., None] * rays_d[:, None, :]
    d2 = (rays_d ** 2)[:, None, :]
    d_norm2 = torch.sum(d2, dim=-1, keepdim=True)
    covs = (t_var[..., None] * d2
            + r_var[..., None] * (1.0 - d2 / torch.clamp(d_norm2, min=1e-10)))
    return means, covs


def init_mipnerf_params(cfg: MipNerfConfig, seed: int = 0) -> dict:
    """{mlp1, mlp2, head} of the one MLP both levels share, numpy, drawn
    from ``default_rng(seed)`` in the JAX package's order."""
    rng = np.random.default_rng(seed)
    return _nerf_mlps_params(rng, 3 * cfg.num_frequencies * 2,
                             3 * cfg.dir_frequencies * 2 + 3, cfg.hidden_dim)


class MipNerfModel(NerfMLPs):
    """mip-NeRF: one field for both levels."""

    def __init__(self, cfg: MipNerfConfig, params: dict, device="cuda"):
        super().__init__(params, device)
        self.cfg = cfg


def mipnerf_params_from_jax(params, cfg: MipNerfConfig,
                            device="cuda") -> MipNerfModel:
    """A :class:`MipNerfModel` holding the JAX package's params."""
    return MipNerfModel(cfg, to_numpy_tree(params), device)


def _mipnerf_level(model: MipNerfModel, rays_o, rays_d, radius, bs,
                   be) -> dict:
    cfg = model.cfg
    with span("rays"):
        means, covs = conical_frustum_gaussian(rays_o, rays_d, bs, be,
                                               radius)
    with span("encode"):
        pe = integrated_pos_enc(means, covs, cfg.num_frequencies)
        de = nerf_frequency_encode(rays_d[:, None, :].expand(means.shape),
                                   cfg.dir_frequencies, 0.0,
                                   cfg.dir_frequencies - 1,
                                   include_input=True)
    with span("base_mlp"):
        h = torch.relu(apply_mlp(model.mlp1, pe))
        h2 = apply_mlp(model.mlp2, torch.cat([h, pe], -1))
        density = F.softplus(h2[..., 0] - 1.0)
        feat = torch.relu(h2[..., 1:])
        rgb = apply_mlp(model.head, torch.cat([feat, de], -1),
                        output_activation="sigmoid")
    with span("composite"):
        w = get_weights_f2nerf(be - bs, density)[0]
        return _render_level(w, rgb, (bs + be) / 2.0, cfg.background_color)


def cone_radius(pixel_area: Optional[torch.Tensor], r: int,
                device) -> torch.Tensor:
    """Each ray's cone radius at unit distance: sqrt(pixel area) / sqrt(3)
    (the division by the constant a multiply by its f32 reciprocal, as XLA
    compiles it), or 1e-3 without a pixel area (the JAX package's eval and
    render pass none)."""
    if pixel_area is None:
        return torch.full((r,), 1e-3, device=device)
    inv = float(np.float32(1.0) / np.float32(1.7320508))
    return torch.sqrt(pixel_area[:, 0]) * inv


def mipnerf_forward(model: MipNerfModel, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    pixel_area: Optional[torch.Tensor] = None,
                    draws: Optional[List[torch.Tensor]] = None) -> dict:
    """Render (R,) rays: {"coarse": ..., "fine": ...} as
    :func:`vanilla_forward`'s, both levels through the one MLP, the fine
    bins resampled by the coarse weights (without the coarse edges).
    ``pixel_area`` (R, 1) sets the cones' radii (training); None gives
    every cone radius 1e-3 (eval and render, as in the JAX package)."""
    cfg = model.cfg
    r = rays_o.shape[0]
    nears, fars = near_far_collider(rays_o, rays_d, cfg.near_plane,
                                    cfg.far_plane)
    radius = cone_radius(pixel_area, r, rays_o.device)
    with span("rays"):
        bs, be, ss, se = spaced_sample(nears, fars, cfg.num_coarse_samples,
                                       jitter=_draw(draws, 0))
    coarse = _mipnerf_level(model, rays_o, rays_d, radius, bs, be)
    with span("rays"):
        ss2, se2 = pdf_sample(ss, se, coarse["weights"],
                              cfg.num_importance_samples, _draw(draws, 1))
        bs2 = ss2 * fars + (1 - ss2) * nears
        be2 = se2 * fars + (1 - se2) * nears
    fine = _mipnerf_level(model, rays_o, rays_d, radius, bs2, be2)
    return {"coarse": coarse, "fine": fine}


def mipnerf_loss(model: MipNerfModel, rays_o, rays_d, target,
                 pixel_area=None, draws=None):
    """(total, (losses, outputs)): 0.1 x the coarse MSE and the fine
    MSE."""
    outs = mipnerf_forward(model, rays_o, rays_d, pixel_area, draws)
    with span("loss"):
        losses = {
            "rgb_loss_coarse": 0.1 * mse_loss(outs["coarse"]["rgb"], target),
            "rgb_loss_fine": mse_loss(outs["fine"]["rgb"], target)}
        total = sum(losses.values())
    return total, (losses, outs)
