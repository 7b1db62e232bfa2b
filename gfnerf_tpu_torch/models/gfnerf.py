"""GF-NeRF model: sampler + field + composite, the render path.

Port of the render half of ``gfnerf_tpu/models/gfnerf.py``: ``sample_rays``
(fast march), the dense branch of ``model_forward`` with the deferred warp,
the fused composite with the background and ``scale_factor`` handling, and
``make_render_fn`` (eval noise == 1).  The field's configuration travels with
the :class:`GFNeRFField` module.

Not ported yet: per-ray budget compaction (``0 < samples_budget_per_ray <
S``) and the focal (block) stage with block-routed rendering, which raise
``NotImplementedError``; proposal resampling and the train step, which have
no config fields here yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.fields.field import (
    STAGE_INIT,
    GFNeRFField,
    field_density,
    field_rgb_per_ray,
)
from gfnerf_tpu_torch.ops.composite import fused_composite
from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast
from gfnerf_tpu_torch.sampler.perssampler import (
    OctreeDevice,
    SamplerConfig,
    warp_points,
)


@dataclasses.dataclass
class GFNeRFModelConfig:
    """The render path's fields of the JAX package's ``GFNeRFModelConfig``
    (gfnerf/config.py:88-130), with its defaults.  The block count lives on
    ``FieldConfig``; the training fields (losses, splits, schedules) join
    with the train step."""

    scale_factor: float = 10.0
    background_color: str = "black"   # "black" | "white" | "last_sample"
    samples_budget_per_ray: int = 256


def sample_rays(oct_dev: OctreeDevice, rays_o, rays_d, noise_unscaled,
                fineness, scfg: SamplerConfig) -> WarpedSamples:
    """The leaf-list march; noise_unscaled in [0.5, 1.5]."""
    if scfg.march != "fast":
        raise NotImplementedError("only the fast (leaf-list) march is ported")
    return get_samples_fast(oct_dev, rays_o, rays_d, noise_unscaled,
                            fineness, scfg)


def model_forward(
    field: GFNeRFField,
    model_cfg: GFNeRFModelConfig,
    samples: WarpedSamples,
    rays_d: torch.Tensor,               # (R, 3)
    rel_camera_indices: torch.Tensor,   # (R,) int
    stage: int,
    oct_dev: OctreeDevice,
):
    """Field + compositing for one ray batch, dense branch
    (gfnerf.py:291-370): the field runs on all R*S sample slots, warped here
    from the march's world points (the deferred warp of the fast march)."""
    r, s = samples.trans_idx.shape
    budget = model_cfg.samples_budget_per_ray
    if 0 < budget < s:
        raise NotImplementedError(
            f"per-ray budget compaction ({budget} < {s} slots) is not ported")
    with record_function("render/warp"):
        n_trans = oct_dev.w2xz.shape[0]
        anc = samples.trans_idx.reshape(-1).clamp(0, n_trans - 1)
        warp = warp_points(oct_dev, anc, samples.world_pts.reshape(-1, 3)
                           ).reshape(r, s, 3)
    density, geo = field_density(field, warp, samples.trans_idx, stage)
    with record_function("render/color_head"):
        heads = field_rgb_per_ray(field, rays_d, geo, rel_camera_indices,
                                  stage)
    with record_function("render/composite"):
        weights, alphas, rgb, acc, depth = fused_composite(
            density, samples.dists, samples.ts, heads["rgb"])
    if model_cfg.background_color == "white":
        rgb = rgb + (1.0 - acc)
    elif model_cfg.background_color == "last_sample":
        rgb = rgb + (1.0 - acc) * heads["rgb"][..., -1, :]
    depth = depth / model_cfg.scale_factor
    oct_depth = samples.first_oct_dis[:, None] / model_cfg.scale_factor
    return {
        "rgb": rgb, "accumulation": acc, "depth": depth,
        "oct_depth": oct_depth, "weights": weights, "alphas": alphas,
    }


def make_render_fn(model_cfg: GFNeRFModelConfig, sampler_cfg: SamplerConfig):
    """Eval/render for a chunk of rays (eval noise == 1,
    PersSampler_cuda.cu:381-383).  Returns ``render_chunk(field, oct_dev,
    rays_o, rays_d, rel_camera_index, active_block=0, stage_is_block=False)``
    -> {rgb, accumulation, depth, oct_depth}."""

    @torch.no_grad()
    def render_chunk(field: GFNeRFField, oct_dev: OctreeDevice,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     rel_camera_index, active_block=0,
                     stage_is_block: bool = False):
        if stage_is_block and field.cfg.n_blocks > 0:
            raise NotImplementedError(
                "focal (block-routed) rendering is not ported")
        r = rays_o.shape[0]
        noise = torch.ones((r, sampler_cfg.max_samples), device=rays_o.device)
        with record_function("render/march"):
            samples = sample_rays(oct_dev, rays_o, rays_d, noise, 1.0,
                                  sampler_cfg)
        rel = torch.as_tensor(rel_camera_index, dtype=torch.int64,
                              device=rays_o.device).expand(r)
        out = model_forward(field, model_cfg, samples, rays_d, rel,
                            STAGE_INIT, oct_dev)
        return {k: out[k] for k in
                ("rgb", "accumulation", "depth", "oct_depth")}

    return render_chunk
