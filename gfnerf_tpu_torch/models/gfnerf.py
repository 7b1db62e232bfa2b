"""GF-NeRF model: sampler + field + composite + losses, render and train.

Port of ``gfnerf_tpu/models/gfnerf.py``: ``sample_rays`` (fast march), the
dense branch of ``model_forward`` with the deferred warp, the fused
composite with the background and ``scale_factor`` handling,
``make_render_fn`` (eval noise == 1), and ``make_train_step`` at the init
stage: rays, march, field, Charbonnier + S3IM, backward, per-group Adam
and the occupancy statistics.  The field's configuration travels with the
:class:`GFNeRFField` module.

Not ported yet: per-ray budget compaction (``0 < samples_budget_per_ray <
S``) and the focal (block) stage, in training and in block-routed
rendering, which raise ``NotImplementedError``; proposal resampling,
semantics and the camera optimizer, which have no config fields here yet.
The JAX package's ``make_multi_train_step`` (K steps per dispatch) has no
counterpart: a plain loop of steps replaces it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gfnerf_tpu_torch.cameras.cameras import Cameras, generate_rays_multi
from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.engine.optimizers import (
    OptState,
    PerGroupAdam,
    apply_updates,
    field_param_grads,
    field_param_groups,
    mask_frozen_grads,
)
from gfnerf_tpu_torch.fields.field import (
    STAGE_INIT,
    GFNeRFField,
    field_density,
    field_rgb_per_ray,
)
from gfnerf_tpu_torch.model_components.losses import (
    charbonnier_loss,
    s3im_loss,
    s3im_permutations,
)
from gfnerf_tpu_torch.ops.composite import fused_composite
from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast
from gfnerf_tpu_torch.sampler.perssampler import (
    OctreeDevice,
    SamplerConfig,
    update_oct_nodes,
    warp_points,
)
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class GFNeRFModelConfig:
    """The fields of the JAX package's ``GFNeRFModelConfig``
    (gfnerf/config.py:88-130) that the render path and the init-stage train
    step read, with its defaults.  The block count lives on
    ``FieldConfig``; the split schedule lives on ``OptimizersConfig``.  The
    train loss is the one the JAX defaults select (method_configs.py:62-67),
    fixed: Charbonnier plus S3IM at weight 1, kernel 4, stride 4, 10
    repeats, patch height 32."""

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
    with span("warp"):
        n_trans = oct_dev.w2xz.shape[0]
        anc = samples.trans_idx.reshape(-1).clamp(0, n_trans - 1)
        warp = warp_points(oct_dev, anc, samples.world_pts.reshape(-1, 3)
                           ).reshape(r, s, 3)
    density, geo = field_density(field, warp, samples.trans_idx, stage)
    with span("color_head"):
        heads = field_rgb_per_ray(field, rays_d, geo, rel_camera_indices,
                                  stage)
    with span("composite"):
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
        with span("march"):
            samples = sample_rays(oct_dev, rays_o, rays_d, noise, 1.0,
                                  sampler_cfg)
        rel = torch.as_tensor(rel_camera_index, dtype=torch.int64,
                              device=rays_o.device).expand(r)
        out = model_forward(field, model_cfg, samples, rays_d, rel,
                            STAGE_INIT, oct_dev)
        return {k: out[k] for k in
                ("rgb", "accumulation", "depth", "oct_depth")}

    return render_chunk


@dataclasses.dataclass
class TrainState:
    """The field (updated in place by each step), the optimizer's state and
    the count of steps taken."""

    field: GFNeRFField
    opt_state: OptState
    step: int = 0


def init_train_state(field: GFNeRFField, tx: PerGroupAdam) -> TrainState:
    return TrainState(field=field,
                      opt_state=tx.init(field_param_groups(field)))


def make_train_step(model_cfg: GFNeRFModelConfig, sampler_cfg: SamplerConfig,
                    tx: PerGroupAdam, stage: int = STAGE_INIT):
    """One training iteration (``_train_step_body``, gfnerf.py:499-664).

    Returns ``train_step(state, oct_dev, cameras, batch, fineness,
    generator=None, noise=None, s3im_perms=None)`` ->
    (state, oct_dev, metrics, per-ray error).  ``batch`` holds
    ``camera_indices``, ``rel_camera_indices`` (R,) int, ``coords`` (R, 2)
    (y, x) and ``image`` (R, 3).  The march noise (R, S) in [0.5, 1.5) and
    the S3IM permutations are drawn from ``generator`` unless passed in.
    Only the init stage is ported: at it the block tables are not in the
    graph, their gradient is a structural zero and they do not change.
    """
    if stage != STAGE_INIT:
        raise NotImplementedError("the focal (block) train step is not "
                                  "ported")
    if sampler_cfg.march != "fast":
        raise NotImplementedError("only the fast (leaf-list) march is ported")

    def train_step(state: TrainState, oct_dev: OctreeDevice, cameras: Cameras,
                   batch: dict, fineness: float,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   s3im_perms: Optional[torch.Tensor] = None):
        field = state.field
        target = batch["image"]
        r = target.shape[0]
        dev = target.device
        with span("rays"):
            rays = generate_rays_multi(cameras, batch["camera_indices"],
                                       batch["coords"])
            if noise is None:   # PersSampler_cuda GetSamples:385-389
                noise = (torch.rand((r, sampler_cfg.max_samples),
                                    generator=generator, device=dev)
                         - 0.5) + 1.0
            if s3im_perms is None:
                s3im_perms = s3im_permutations(r, generator=generator,
                                               device=dev)
        # sample positions are not optimized (the reference's CUDA sampler
        # has no autograd either)
        with span("march"), torch.no_grad():
            samples = sample_rays(oct_dev, rays["origins"],
                                  rays["directions"], noise, fineness,
                                  sampler_cfg)

        field.zero_grad(set_to_none=True)
        out = model_forward(field, model_cfg, samples, rays["directions"],
                            batch["rel_camera_indices"], stage, oct_dev)
        with span("loss"):
            losses = {"rgb_loss": charbonnier_loss(out["rgb"], target),
                      "s3im_loss": s3im_loss(out["rgb"], target, s3im_perms)}
            total = losses["rgb_loss"] + losses["s3im_loss"]
        with span("backward"):
            total.backward()
        with span("optimizer"):
            params = field_param_groups(field)
            grads = mask_frozen_grads(field_param_grads(field), stage)
            updates, opt_state = tx.update(grads, state.opt_state, params)
            # freezing masks the updates, not just the grads: Adam's moments
            # turn zero grads into nonzero updates (gfnerf.py:625-631)
            apply_updates(params, mask_frozen_grads(updates, stage))
        new_state = TrainState(field=field, opt_state=opt_state,
                               step=state.step + 1)
        with span("occupancy"), torch.no_grad():
            # occupancy stats only during init (nerfacto.py:605-614)
            oct_dev = update_oct_nodes(oct_dev, samples,
                                       out["weights"].detach(),
                                       out["alphas"].detach())
            rgb = out["rgb"].detach()
            err = torch.sum(torch.abs(rgb - target), dim=-1)  # gf_pipeline:179
            mse = torch.mean((rgb - target) ** 2)
            metrics = {
                "loss": total.detach(),
                **{k: v.detach() for k, v in losses.items()},
                "psnr": -10.0 * torch.log10(mse + 1e-12),
                "num_samples_per_ray": samples.num_valid.float().mean(),
            }
            if samples.num_hits is not None:
                # rays whose farthest leaf hits the max_hits top-k dropped
                metrics["frac_truncated_rays"] = (
                    samples.num_hits > sampler_cfg.max_hits).float().mean()
        return new_state, oct_dev, metrics, err

    return train_step
