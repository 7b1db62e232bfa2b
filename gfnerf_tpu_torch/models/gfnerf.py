"""GF-NeRF model: sampler + field + composite + losses, render and train.

Port of ``gfnerf_tpu/models/gfnerf.py``: ``sample_rays`` (the fast march,
or the scan march, kernel M1 on the card), ``model_forward`` in both
branches, the warp deferred to the model after the fast march and read
from the samples after the scan march: the dense one
(the field on all R*S sample slots) and, when ``0 < samples_budget_per_ray
< S``, the compacted one (each ray's first ``budget`` valid samples
gathered into a (R * budget,) buffer, warped and evaluated there and
scattered back; at the block stage also with a block per ray), each with
``remat_chunks``, and, with ``num_proposal_resamples`` > 0 and the field's
proposal probe, the proposal branch (the probe on the t-sorted marched
lattice, its weights importance-resampled into K fine samples a ray by
``pdf_sample``, the main field on those); the identity-warp ablation in
every branch; the fused composite with the background and
``scale_factor`` handling, ``make_render_fn`` (eval noise == 1; at the block
stage with one block or with a block per ray), and ``make_train_step`` at
both stages: rays, march, field, Charbonnier + S3IM (at the block stage
also the finetune trust region and the empty-space penalty; on the
proposal branch the interlevel loss and the distortion loss; with the
field's semantics heads the semantics cross-entropy; with its camera
tangents the rays moved by them before the field, the march left on the
rays as generated, and their L2 penalty), backward, per-group Adam, and
at the init stage the occupancy statistics.  The field's configuration
travels with the :class:`GFNeRFField` module.

The JAX package's ``make_multi_train_step`` (K steps per dispatch) has no
counterpart: a plain loop of steps replaces it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gfnerf_tpu_torch.cameras.camera_optimizers import (
    CameraOptimizerConfig,
    apply_to_rays,
    pose_regularization,
)
from gfnerf_tpu_torch.cameras.cameras import Cameras, generate_rays_multi
from gfnerf_tpu_torch.cameras.rays import WarpedSamples, get_weights_f2nerf
from gfnerf_tpu_torch.engine.optimizers import (
    OptState,
    PerGroupAdam,
    active_block_table,
    all_reduce_grads,
    apply_updates,
    field_param_grads,
    field_param_groups,
    frozen_groups,
)
from gfnerf_tpu_torch.fields.field import (
    STAGE_BLOCK,
    STAGE_INIT,
    FieldConfig,
    GFNeRFField,
    _head_ray_pre,
    field_density,
    field_density_routed,
    field_rgb_compact,
    field_rgb_per_ray,
    proposal_density,
)
from gfnerf_tpu_torch.model_components.losses import (
    charbonnier_loss,
    distortion_loss,
    interlevel_loss,
    mse_loss,
    s3im_loss,
    s3im_loss_whole_batch,
    s3im_permutations,
)
from gfnerf_tpu_torch.model_components.ray_samplers import pdf_sample
from gfnerf_tpu_torch.model_components.renderers import render_weighted
from gfnerf_tpu_torch.ops.composite import fused_composite
from gfnerf_tpu_torch.ops.scan_march import scan_march
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
    (gfnerf/config.py:88-130) that the render path, the train step and the
    pipeline read, with its defaults.  The pipeline reads the block count
    and the split schedule.  The train loss: the rgb term, Charbonnier
    (``use_ch_loss``, the default) or MSE, plus S3IM at
    ``s3im_loss_mult`` (0 drops it) with its kernel, stride, repeats and
    patch height.  With ``use_semantics`` (and the field's semantics heads)
    the rendered logits' cross-entropy against the batch's labels joins at
    ``semantic_loss_weight``."""

    n_blocks: int = 10
    n_split_dataset: int = 10
    steps_per_split_dataset: int = 10000
    steps_perssampler_init: int = 30000
    use_ch_loss: bool = True
    s3im_loss_mult: float = 1.0
    s3im_kernel_size: int = 4
    s3im_stride: int = 4
    s3im_repeat_time: int = 10
    s3im_patch_height: int = 32
    scale_factor: float = 10.0
    background_color: str = "black"   # "black" | "white" | "last_sample"
    samples_budget_per_ray: int = 256
    # block stage, residual mode: > 0 penalizes density the residual adds,
    # relu(density - shared density), averaged over the samples the frozen
    # shared branch deems empty (its alpha < empty_space_tau)
    empty_space_penalty_mult: float = 0.0
    empty_space_tau: float = 0.01
    # block stage, finetune mode: > 0 pulls the active table toward the
    # frozen global table, mult * mean((table - global)^2)
    finetune_trust_mult: float = 0.0
    # > 1: the field's evaluation under a gradient runs in this many chunks
    # (points when compacting, which it must divide; rays otherwise), each
    # recomputed in the backward instead of keeping its activations
    remat_chunks: int = 0
    # > 0 (with the field's proposal probe, and no compaction): the probe's
    # weights on the marched lattice importance-resample this many fine
    # samples a ray, on which the main field runs; the probe learns from the
    # interlevel loss, and the distortion loss (if its mult is > 0)
    # regularizes the fine weights
    num_proposal_resamples: int = 0
    proposal_interlevel_mult: float = 1.0
    distortion_loss_mult: float = 0.0
    use_semantics: bool = False
    semantic_loss_weight: float = 0.0


def sample_rays(oct_dev: OctreeDevice, rays_o, rays_d, noise_unscaled,
                fineness, scfg: SamplerConfig) -> WarpedSamples:
    """The vectorized leaf-list march ("fast") or the sequential
    point-location march ("scan", which fills ``warp_pts``);
    noise_unscaled in [0.5, 1.5]."""
    if scfg.march == "fast":
        return get_samples_fast(oct_dev, rays_o, rays_d, noise_unscaled,
                                fineness, scfg)
    if scfg.march != "scan":
        raise ValueError(f"unknown march {scfg.march!r}")
    return scan_march(oct_dev, rays_o, rays_d, noise_unscaled * fineness,
                      scfg)


def warp_or_identity(field_cfg: FieldConfig, oct_dev: OctreeDevice,
                     anchors: torch.Tensor,
                     world_pts: torch.Tensor) -> torch.Tensor:
    """``warp_points`` of world points (P, 3) at clipped anchors (P,), or
    with ``warp_mode="identity"`` the ablation's world / scale clipped to
    [-1.5, 1.5], the division rounded as XLA compiles it (a multiply by
    the f32 reciprocal; gfnerf.py:58-62)."""
    if field_cfg.warp_mode == "identity":
        inv = np.float32(1.0) / np.float32(field_cfg.identity_warp_scale)
        return torch.clamp(world_pts * float(inv), -1.5, 1.5)
    return warp_points(oct_dev, anchors, world_pts)


def compact_indices(valid: torch.Tensor, budget: int) -> torch.Tensor:
    """The flat (R * S) slots of each ray's first ``budget`` valid samples,
    in slot order, in a (R * budget,) buffer padded with R * S: the JAX
    package's ``jnp.nonzero(keep, size=k, fill_value=r * s)``, built with
    no host sync (a cumulative sum gives each kept slot its place, a
    scatter puts it there).  The per-ray cap keeps at most R * budget
    slots, so none is cut."""
    r, s = valid.shape
    k = r * budget
    cum = torch.cumsum(valid.to(torch.int32), dim=1)
    keep = (valid & (cum <= budget)).reshape(-1)
    place = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    # the slots not kept go to one spare place past the end
    place = torch.where(keep, place, k)
    idx = torch.full((k + 1,), r * s, dtype=torch.int64, device=valid.device)
    idx.scatter_(0, place, torch.arange(r * s, device=valid.device))
    return idx[:k]


def compact_samples(samples: WarpedSamples, budget: int,
                    oct_dev: OctreeDevice, field_cfg: FieldConfig):
    """Each ray's first ``budget`` valid samples, warped: (the flat slots
    ``idx`` (K,), padded with R * S; the anchors (K,), -1 at the pads; the
    rays (K,); the warped points (K, 3)), K = R * budget.  No host sync.

    A pad's ray is its place mod R, whose values are dropped: the
    backward of the colour head's gather ``ray_pre[ray_k]`` serializes
    equal indices, and with all pads on one ray (the JAX package's
    ``safe // s``) a march of few valid samples, the first steps' at
    fineness 16, spent 1.37 s of a 1.47 s step there on an H100.  The
    scan march's ``warp_pts`` are gathered; after the fast march, which
    leaves them None, the points are warped as ``field_cfg`` says
    (``warp_or_identity``)."""
    r, s = samples.trans_idx.shape
    with span("compact"):
        idx = compact_indices(samples.valid, budget)
        pad = idx >= r * s
        safe = idx.clamp(max=r * s - 1)
        anc_k = torch.where(pad, -1, samples.trans_idx.reshape(-1)[safe])
        ray_k = torch.where(pad, torch.arange(idx.shape[0],
                                              device=idx.device) % r,
                            safe // s)
    with span("warp"):
        if samples.warp_pts is None:
            warp_k = warp_or_identity(
                field_cfg, oct_dev, anc_k.clamp(0, oct_dev.w2xz.shape[0] - 1),
                samples.world_pts.reshape(-1, 3)[safe])
        else:
            warp_k = samples.warp_pts.reshape(-1, 3)[safe]
    return idx, anc_k, ray_k, warp_k


def scatter_slots(idx: torch.Tensor, vals: torch.Tensor, r: int,
                  s: int) -> torch.Tensor:
    """(K, ...) values of the kept slots ``idx`` (pads = r * s, dropped)
    back on an (R, S, ...) grid of zeros; differentiable in ``vals`` (its
    backward gathers)."""
    out = vals.new_zeros((r * s + 1,) + vals.shape[1:])
    return out.index_copy(0, idx, vals)[:r * s].reshape(
        (r, s) + vals.shape[1:])


def _chunked(n_chunks: int, fn, *args):
    """``fn`` over ``n_chunks`` equal chunks of its tensor arguments (dim
    0), each through ``torch.utils.checkpoint``: its activations are
    recomputed in the backward.  ``fn`` returns a tuple of tensors (or
    None) or a dict of them in its last place; the chunks' results are
    concatenated."""
    outs = [checkpoint(fn, *parts, use_reentrant=False)
            for parts in zip(*(a.chunk(n_chunks) for a in args))]

    def cat(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], dict):
            return {name: torch.cat([x[name] for x in xs]) for name in xs[0]}
        return torch.cat(xs)

    return tuple(cat(list(xs)) for xs in zip(*outs))


def model_forward(
    field: GFNeRFField,
    model_cfg: GFNeRFModelConfig,
    samples: WarpedSamples,
    rays_d: torch.Tensor,               # (R, 3)
    rel_camera_indices: torch.Tensor,   # (R,) int
    stage: int,
    oct_dev: OctreeDevice,
    active_block: int = 0,
    active_table: Optional[torch.Tensor] = None,
    routed_blocks: Optional[torch.Tensor] = None,   # (R,) block per ray
    rays_o: Optional[torch.Tensor] = None,          # (R, 3)
    prop_u: Optional[torch.Tensor] = None,     # (R, K + 1) in [0, 1)
):
    """Field + compositing for one ray batch (gfnerf.py:149-370).  The
    warped coordinates are the samples' ``warp_pts`` (the scan march's);
    where those are None (the fast march's) they come from the world
    points here, the JAX package's ``warp_deferred``.  The proposal branch
    warps its t-sorted world points after either march, as the JAX
    package's does.

    With ``0 < samples_budget_per_ray < S`` the field runs only on each
    ray's first ``budget`` valid samples (the reference's per-ray
    ``num_nerf_samples_per_ray``), gathered into a (R * budget,) buffer
    (:func:`compact_samples`; pad slots at anchor -1), warped there, and
    scattered back to (R, S) with the pads dropped; the other slots have
    density and colour 0.  Otherwise it runs on all R * S slots.

    At the block stage the field adds block ``active_block``'s table
    (``active_table``, if given, in its place: the train step's leaf), or,
    with ``routed_blocks`` (eval only), each ray's own block's.  With the
    empty-space penalty on, the train path also returns "density" and
    "density_shared" (R, S).  ``remat_chunks`` > 1 evaluates the field in
    that many checkpointed chunks of points (compacted; it must divide R *
    budget) or of rays (dense; it must divide R) when a gradient is being
    recorded: the same outputs and gradients, activations recomputed in
    the backward.

    Without compaction, with ``num_proposal_resamples`` > 0, the field's
    proposal probe and ``rays_o``, the proposal branch runs instead
    (:func:`_model_forward_proposal`; the uniform draws ``prop_u`` (R, K +
    1) stratify its resampling, None in eval)."""
    r, s = samples.trans_idx.shape
    budget = model_cfg.samples_budget_per_ray
    routed = routed_blocks is not None and stage == STAGE_BLOCK
    # the penalty is train-only
    with_shared = (stage == STAGE_BLOCK and not routed
                   and model_cfg.empty_space_penalty_mult > 0)
    n_chunks = model_cfg.remat_chunks if torch.is_grad_enabled() else 0

    def density_fn(warp, anc):
        out = field_density(field, warp, anc, stage, active_block,
                            active_table, with_shared)
        return out if with_shared else out + (None,)

    density_shared = None
    if not 0 < budget < s and model_cfg.num_proposal_resamples > 0 \
            and field.prop_feat is not None and rays_o is not None:
        if routed:
            raise ValueError("the proposal branch renders one block a "
                             "chunk, not a block per ray")
        return _model_forward_proposal(
            field, model_cfg, samples, rays_o, rays_d, rel_camera_indices,
            stage, oct_dev, active_block, active_table, prop_u)
    if 0 < budget < s:
        k = r * budget
        idx, anc_k, ray_k, warp_k = compact_samples(samples, budget, oct_dev,
                                                    field.cfg)
        with span("color_head"):
            ray_pre = _head_ray_pre(field, rays_d, rel_camera_indices)

        def eval_points(warp, anc, ray):
            dk, geo, shared = density_fn(warp, anc)
            with span("color_head"):
                return dk, shared, field_rgb_compact(field, ray_pre, geo, ray)

        if routed:
            blk_k = torch.where(idx >= r * s, -1, routed_blocks[ray_k])
            density_k, geo_k = field_density_routed(field, warp_k, anc_k,
                                                    blk_k)
            shared_k = None
            with span("color_head"):
                heads_k = field_rgb_compact(field, ray_pre, geo_k, ray_k)
        elif n_chunks > 1:
            if k % n_chunks:
                raise ValueError(f"remat_chunks={n_chunks} must divide "
                                 f"rays*budget={k}")
            density_k, shared_k, heads_k = _chunked(
                n_chunks, eval_points, warp_k, anc_k, ray_k)
        else:
            density_k, shared_k, heads_k = eval_points(warp_k, anc_k, ray_k)
        with span("compact"):
            density = scatter_slots(idx, density_k, r, s)
            if shared_k is not None:
                density_shared = scatter_slots(idx, shared_k, r, s)
            heads = {name: scatter_slots(idx, val, r, s)
                     for name, val in heads_k.items()}
    else:
        with span("warp"):
            if samples.warp_pts is None:
                anc = samples.trans_idx.reshape(-1).clamp(
                    0, oct_dev.w2xz.shape[0] - 1)
                warp = warp_or_identity(field.cfg, oct_dev, anc,
                                        samples.world_pts.reshape(-1, 3)
                                        ).reshape(r, s, 3)
            else:
                warp = samples.warp_pts

        def eval_rays(warp, anc, dirs, rel):
            density, geo, shared = density_fn(warp, anc)
            with span("color_head"):
                return density, shared, field_rgb_per_ray(field, dirs, geo,
                                                          rel, stage)

        if routed:
            density, geo = field_density_routed(
                field, warp, samples.trans_idx,
                routed_blocks[:, None].expand(r, s))
            with span("color_head"):
                heads = field_rgb_per_ray(field, rays_d, geo,
                                          rel_camera_indices, stage)
        elif n_chunks > 1:
            if r % n_chunks:
                raise ValueError(f"remat_chunks={n_chunks} must divide "
                                 f"rays={r}")
            density, density_shared, heads = _chunked(
                n_chunks, eval_rays, warp, samples.trans_idx, rays_d,
                rel_camera_indices)
        else:
            density, density_shared, heads = eval_rays(
                warp, samples.trans_idx, rays_d, rel_camera_indices)
    out = _composite_out(model_cfg, samples, density, samples.dists,
                         samples.ts, heads["rgb"])
    if density_shared is not None:
        out["density"] = density
        out["density_shared"] = density_shared
    return _semantics_out(model_cfg, out, heads)


def _semantics_out(model_cfg: GFNeRFModelConfig, out: dict,
                   heads: dict) -> dict:
    """``out`` with the per-sample semantic logits rendered by the weights
    (R, classes), when the model and the field both have them."""
    if model_cfg.use_semantics and "semantics" in heads:
        out["semantics"] = render_weighted(out["weights"],
                                           heads["semantics"])
    return out


def _composite_out(model_cfg: GFNeRFModelConfig, samples: WarpedSamples,
                   density, dists, ts, rgb_s) -> dict:
    """The fused composite of (R, S) densities, spacings, positions and
    (R, S, 3) colours, with the background and ``scale_factor``: {rgb,
    accumulation, depth, oct_depth, weights, alphas}."""
    with span("composite"):
        weights, alphas, rgb, acc, depth = fused_composite(density, dists,
                                                           ts, rgb_s)
    if model_cfg.background_color == "white":
        rgb = rgb + (1.0 - acc)
    elif model_cfg.background_color == "last_sample":
        rgb = rgb + (1.0 - acc) * rgb_s[..., -1, :]
    depth = depth / model_cfg.scale_factor
    oct_depth = samples.first_oct_dis[:, None] / model_cfg.scale_factor
    return {"rgb": rgb, "accumulation": acc, "depth": depth,
            "oct_depth": oct_depth, "weights": weights, "alphas": alphas}


def _model_forward_proposal(field: GFNeRFField, model_cfg, samples,
                            rays_o, rays_d, rel_camera_indices, stage,
                            oct_dev, active_block, active_table,
                            prop_u):
    """Proposal-guided resampling on the marched lattice
    (gfnerf.py:381-470):

    1. each ray's samples sorted by t (a stable sort, invalid slots last)
       and warped; the probe's density there (its graph only at the init
       stage: it is frozen at the block stage);
    2. monotone bin edges (the invalid tail at the ray's last end, a
       running max, each bin ending where the next starts) and the probe's
       weights on them;
    3. K = ``num_proposal_resamples`` fine bins drawn from those weights
       (``pdf_sample``), each fine sample at its bin's middle, anchored in
       the marched segment that holds it (the count of segment starts at
       or below it, less one), masked where that segment is invalid;
    4. the main field and the fused composite on the (R, K) fine samples.

    Besides the render outputs it returns "prop_weights", "prop_spacing"
    and "fine_spacing" for the interlevel loss, and "march_weights" /
    "march_alphas", the probe's weights and alphas, for the occupancy
    statistics (in t-sorted order, which the JAX package pairs with the
    samples in march order)."""
    r, s = samples.trans_idx.shape
    k = model_cfg.num_proposal_resamples
    n_trans = oct_dev.w2xz.shape[0]
    cfg = field.cfg
    with span("proposal"):
        order = torch.argsort(
            torch.where(samples.valid, samples.ts, float("inf")), dim=1,
            stable=True)

        def take(x):
            return torch.gather(x, 1, order)

        ts_m, de_m = take(samples.ts), take(samples.dists)
        anc_m, valid = take(samples.trans_idx), take(samples.valid)
        world_m = torch.gather(samples.world_pts, 1,
                               order[..., None].expand(r, s, 3))
    with span("warp"):
        warp_m = warp_or_identity(cfg, oct_dev,
                                  anc_m.reshape(-1).clamp(0, n_trans - 1),
                                  world_m.reshape(-1, 3)).reshape(r, s, 3)
    with span("proposal"):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and stage == STAGE_INIT):
            dens_p = proposal_density(field, warp_m, anc_m)
            t_max = torch.amax(torch.where(valid, ts_m + de_m, 0.0), dim=1,
                               keepdim=True)
            ts_fix = torch.cummax(torch.where(valid, ts_m, t_max),
                                  dim=1).values
            de_fix = torch.where(valid, de_m, 0.0)
            ends_fix = torch.cat([ts_fix[:, 1:],
                                  ts_fix[:, -1:] + de_fix[:, -1:]], dim=1)
            w_prop, a_prop, _ = get_weights_f2nerf(de_fix, dens_p)
        bs, be = pdf_sample(ts_fix, ends_fix, w_prop, k, prop_u)
        t_f = (bs + be) / 2.0                                   # (R, K)
        # ts_fix is monotone: the count of starts <= t_f is a searchsorted
        seg = torch.clamp(torch.searchsorted(ts_fix, t_f, right=True) - 1,
                          0, s - 1)
        anc_f = torch.where(torch.gather(valid, 1, seg),
                            torch.gather(anc_m, 1, seg), -1)
    with span("warp"):
        # a masked fine sample sits at the origin of the march's masked
        # slots, not at t = 0 on its ray: the warp is singular at a camera
        # centre, and its NaN would reach the plain encode's masked output
        # and the table gradient (the JAX package's jitted encode selects
        # zeros there; the kernels skip masked points)
        pos_f = torch.where(
            anc_f[..., None] >= 0,
            rays_o[:, None, :] + t_f[..., None] * rays_d[:, None, :], 0.0)
        warp_f = warp_or_identity(cfg, oct_dev,
                                  anc_f.reshape(-1).clamp(0, n_trans - 1),
                                  pos_f.reshape(-1, 3)).reshape(r, k, 3)
    density, geo = field_density(field, warp_f, anc_f, stage, active_block,
                                 active_table)
    with span("color_head"):
        heads = field_rgb_per_ray(field, rays_d, geo, rel_camera_indices,
                                  stage)
    out = _composite_out(model_cfg, samples, density, be - bs, t_f,
                         heads["rgb"])
    out.update(prop_weights=w_prop, prop_spacing=(ts_fix, ends_fix),
               fine_spacing=(bs, be), march_weights=w_prop,
               march_alphas=a_prop, fine_anchors=anc_f)
    return _semantics_out(model_cfg, out, heads)


RENDER_KEYS = ("rgb", "accumulation", "depth", "oct_depth")


def render_forward(field: GFNeRFField, model_cfg: GFNeRFModelConfig,
                   samples: WarpedSamples, rays_d: torch.Tensor,
                   rel_camera_index, oct_dev: OctreeDevice, active_block=0,
                   stage_is_block: bool = False,
                   rays_o: Optional[torch.Tensor] = None) -> dict:
    """``model_forward`` as a render calls it: ``rel_camera_index`` one
    index or an (R,) tensor; with ``stage_is_block`` the focal field, with
    ``active_block`` one block for the chunk or an (R,) tensor with a block
    per ray (packed layout, not on the proposal branch).  ``rays_o`` lets
    the proposal branch run (its fine samples are placed on the rays).
    Returns the full output dict."""
    r = rays_d.shape[0]
    rel = torch.as_tensor(rel_camera_index, dtype=torch.int64,
                          device=rays_d.device).expand(r)
    if not (stage_is_block and field.cfg.n_blocks > 0):
        return model_forward(field, model_cfg, samples, rays_d, rel,
                             STAGE_INIT, oct_dev, rays_o=rays_o)
    routed = None
    if not isinstance(active_block, int):
        active_block = torch.as_tensor(active_block, device=rays_d.device)
        if active_block.dim() == 1:
            if field.cfg.hash_layout != "packed":
                raise ValueError("a block per ray needs the packed layout")
            if active_block.shape[0] != r:
                raise ValueError(
                    f"{active_block.shape[0]} blocks for {r} rays")
            routed, active_block = active_block, 0
    return model_forward(field, model_cfg, samples, rays_d, rel, STAGE_BLOCK,
                         oct_dev, int(active_block), routed_blocks=routed,
                         rays_o=rays_o)


def make_render_fn(model_cfg: GFNeRFModelConfig, sampler_cfg: SamplerConfig):
    """Eval/render for a chunk of rays (eval noise == 1,
    PersSampler_cuda.cu:381-383).  Returns ``render_chunk(field, oct_dev,
    rays_o, rays_d, rel_camera_index, active_block=0, stage_is_block=False)``
    -> {rgb, accumulation, depth, oct_depth}.  With ``stage_is_block`` the
    focal field renders: ``active_block`` is one block for the chunk, or an
    (R,) tensor with a block per ray (packed layout), so that a chunk may
    mix rays of every cluster."""

    @torch.no_grad()
    def render_chunk(field: GFNeRFField, oct_dev: OctreeDevice,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     rel_camera_index, active_block=0,
                     stage_is_block: bool = False):
        r = rays_o.shape[0]
        noise = torch.ones((r, sampler_cfg.max_samples), device=rays_o.device)
        with span("march"):
            samples = sample_rays(oct_dev, rays_o, rays_d, noise, 1.0,
                                  sampler_cfg)
        out = render_forward(field, model_cfg, samples, rays_d,
                             rel_camera_index, oct_dev, active_block,
                             stage_is_block, rays_o)
        return {k: out[k] for k in RENDER_KEYS}

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
                    tx: PerGroupAdam, stage: int = STAGE_INIT, comm=None):
    """One training iteration (``_train_step_body``, gfnerf.py:499-664).

    Returns ``train_step(state, oct_dev, cameras, batch, fineness,
    generator=None, noise=None, s3im_perms=None, active_block=0,
    prop_u=None)`` -> (state, oct_dev, metrics, per-ray error).  ``batch``
    holds ``camera_indices``, ``rel_camera_indices`` (R,) int, ``coords``
    (R, 2) (y, x) and ``image`` (R, 3).  The march noise (R, S) in [0.5,
    1.5), the S3IM permutations and, on the proposal branch, the
    resampling's uniform draws ``prop_u`` (R, K + 1) in [0, 1) are drawn
    from ``generator`` unless passed in.

    The optimizer's "block" group is block ``active_block``'s table, a leaf
    of its own that shares the stack's storage
    (``optimizers.active_block_table``), so its in-place update is the
    write-back into ``field.block_feats``.  At the init stage the block
    tables are not in the graph: that gradient is a structural zero and
    the tables do not change.  At the block stage only that table is in
    the graph and only it changes; the frozen groups get no gradient, their
    moments decay, and their updates are dropped; the occupancy statistics
    stay.  The proposal probe and the semantics heads are in the "fields"
    group, the camera tangents in "camera_opt": all frozen at the block
    stage (the probe runs without a graph there).  The camera tangents
    move each ray (``apply_to_rays``) after the march, which keeps the
    rays as generated; the field sees the moved ones.  ``batch`` may hold
    ``semantics`` (R,) int labels, which the semantics loss reads.  On the
    proposal branch the init stage's occupancy statistics read the probe's
    weights on the marched lattice, as the JAX package's do.  The caller
    re-initialises the optimizer state (``tx.init``) when the active block
    changes, as the JAX pipeline does at a split switch.

    ``comm`` (a :class:`~gfnerf_tpu_torch.parallel.comm.Comm`; None: one
    card) makes it the data-parallel step: each rank passes its slice of
    the whole batch (rank k the k-th of equal slices) and the whole batch's
    draws (``noise``, ``s3im_perms``, ``prop_u``, or the same generator
    state on every rank), and the step equals the one-card step on the
    whole batch.  Each ray-mean term is this rank's share of the whole
    batch's (times R / R_all); the empty-space term's count is the whole
    batch's; S3IM runs over the gathered batch (``s3im_loss_whole_batch``);
    the terms of the parameters alone (trust, camera regularizer) enter
    rank 0's backward only.  The gradients are summed over the ranks
    (``all_reduce_grads``) before the clip and Adam, so every rank applies
    the same update; the occupancy statistics merge by a maximum
    (``update_oct_nodes``); the metrics are the whole batch's, on every
    rank.  The per-ray error stays this rank's.
    """
    if stage not in (STAGE_INIT, STAGE_BLOCK):
        raise ValueError(f"unknown stage {stage}")
    block_stage = stage == STAGE_BLOCK
    frozen = frozen_groups(stage)

    def train_step(state: TrainState, oct_dev: OctreeDevice, cameras: Cameras,
                   batch: dict, fineness: float,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   s3im_perms: Optional[torch.Tensor] = None,
                   active_block: int = 0,
                   prop_u: Optional[torch.Tensor] = None):
        field = state.field
        if block_stage and field.block_feats is None:
            raise ValueError("the block stage needs block tables "
                             "(n_blocks > 0)")
        target = batch["image"]
        r = target.shape[0]
        dev = target.device
        # data-parallel: this rank's rays are [lo, lo + r) of the r_all
        r_all, lo = (r, 0) if comm is None else (r * comm.size,
                                                 r * comm.rank)
        with span("rays"):
            rays = generate_rays_multi(cameras, batch["camera_indices"],
                                       batch["coords"])
            if noise is None:   # PersSampler_cuda GetSamples:385-389
                noise = (torch.rand((r_all, sampler_cfg.max_samples),
                                    generator=generator, device=dev)
                         - 0.5) + 1.0
            if s3im_perms is None and model_cfg.s3im_loss_mult > 0:
                s3im_perms = s3im_permutations(
                    r_all, model_cfg.s3im_repeat_time, generator=generator,
                    device=dev)
            k = model_cfg.num_proposal_resamples
            if prop_u is None and k > 0 and field.prop_feat is not None:
                prop_u = torch.rand((r_all, k + 1), generator=generator,
                                    device=dev)
            if comm is not None:
                noise = noise[lo:lo + r]
                prop_u = None if prop_u is None else prop_u[lo:lo + r]
        # sample positions are not optimized (the reference's CUDA sampler
        # has no autograd either)
        with span("march"), torch.no_grad():
            samples = sample_rays(oct_dev, rays["origins"],
                                  rays["directions"], noise, fineness,
                                  sampler_cfg)

        field.zero_grad(set_to_none=True)
        active_table = (None if field.block_feats is None else
                        active_block_table(field, active_block,
                                           requires_grad=block_stage))
        cam_cfg = CameraOptimizerConfig(mode=field.cfg.camera_opt_mode)
        rays_o, rays_d = rays["origins"], rays["directions"]
        if field.camera_adjustment is not None:
            with span("rays"):
                rays_o, rays_d = apply_to_rays(
                    cam_cfg, field.camera_adjustment,
                    batch["camera_indices"], rays_o, rays_d)
        out = model_forward(field, model_cfg, samples, rays_d,
                            batch["rel_camera_indices"], stage, oct_dev,
                            active_block, active_table, rays_o=rays_o,
                            prop_u=prop_u)
        # a ray-mean term of this rank's rays as its share of the whole
        # batch's (R / R_all); the terms of the parameters alone enter one
        # rank's backward
        share = r / r_all
        param_terms = ("trust_loss", "camera_opt_regularizer")
        whole_terms = ("s3im_loss", *param_terms)

        def part(term):
            return term if comm is None else term * share

        with span("loss"):
            rgb_loss = (charbonnier_loss if model_cfg.use_ch_loss
                        else mse_loss)
            losses = {"rgb_loss": part(rgb_loss(out["rgb"], target))}
            if (block_stage and field.cfg.focal_mode == "finetune"
                    and model_cfg.finetune_trust_mult > 0):
                losses["trust_loss"] = model_cfg.finetune_trust_mult \
                    * torch.mean((active_table
                                  - field.global_feat.detach()) ** 2)
            if "density_shared" in out:
                # penalize density the residual adds where the frozen shared
                # branch says empty; carving (a negative delta) stays free
                ds = out["density_shared"]
                alpha_s = 1.0 - torch.exp(-ds * samples.dists)
                empty = ((alpha_s < model_cfg.empty_space_tau)
                         & samples.valid).to(ds.dtype)
                delta = torch.relu(out["density"] - ds)
                n_empty = torch.sum(empty)
                if comm is not None:   # the whole batch's count
                    n_empty = comm.all_reduce(n_empty.detach().clone())
                losses["empty_space_loss"] = (
                    model_cfg.empty_space_penalty_mult
                    * torch.sum(delta * empty)
                    / torch.clamp(n_empty, min=1.0))
            if "prop_weights" in out:
                fb_s, fb_e = out["fine_spacing"]
                losses["interlevel_loss"] = part(
                    model_cfg.proposal_interlevel_mult * interlevel_loss(
                        out["weights"], fb_s, fb_e, out["prop_weights"],
                        *out["prop_spacing"]))
                if model_cfg.distortion_loss_mult > 0:
                    losses["distortion_loss"] = part(
                        model_cfg.distortion_loss_mult * distortion_loss(
                            out["weights"], fb_s, fb_e))
            if model_cfg.s3im_loss_mult > 0:
                s3im_kw = dict(kernel_size=model_cfg.s3im_kernel_size,
                               stride=model_cfg.s3im_stride,
                               patch_height=model_cfg.s3im_patch_height)
                losses["s3im_loss"] = model_cfg.s3im_loss_mult * (
                    s3im_loss(out["rgb"], target, s3im_perms, **s3im_kw)
                    if comm is None else s3im_loss_whole_batch(
                        out["rgb"], target, s3im_perms, comm, **s3im_kw))
            if "semantics" in out and "semantics" in batch:
                # cross-entropy of the rendered logits (nerfacto.py:676-681)
                logp = torch.log_softmax(out["semantics"], dim=-1)
                ce = -torch.gather(logp, 1,
                                   batch["semantics"].long()[:, None])[:, 0]
                losses["semantics_loss"] = part(
                    model_cfg.semantic_loss_weight * torch.mean(ce))
            if field.camera_adjustment is not None:
                losses["camera_opt_regularizer"] = pose_regularization(
                    cam_cfg, field.camera_adjustment)
            total = sum(losses.values()) if comm is None else sum(
                v for k, v in losses.items()
                if k not in param_terms or comm.rank == 0)
        with span("backward"):
            # at the block stage the frozen parameters stay out of the
            # backward: their gradients would be masked to zero anyway
            total.backward(inputs=[active_table] if block_stage else None)
        with span("optimizer"):
            params = field_param_groups(field, active_table)
            grads = field_param_grads(field, active_table)
            if comm is not None:   # the whole batch's gradient, every rank
                grads = all_reduce_grads(grads, comm)
            updates, opt_state = tx.update(grads, state.opt_state, params)
            # each group's gradient norm before the clip (max_norm only)
            grad_norms = {f"grad_norm_{name}": n
                          for name, n in tx.grad_norms.items()}
            # freezing masks the updates, not just the grads: Adam's moments
            # turn zero grads into nonzero updates (gfnerf.py:625-631)
            apply_updates({name: ps for name, ps in params.items()
                           if name not in frozen}, updates)
        new_state = TrainState(field=field, opt_state=opt_state,
                               step=state.step + 1)
        with span("occupancy"), torch.no_grad():
            if not block_stage:
                # occupancy stats only during init (nerfacto.py:605-614)
                oct_dev = update_oct_nodes(
                    oct_dev, samples,
                    out.get("march_weights", out["weights"]).detach(),
                    out.get("march_alphas", out["alphas"]).detach(),
                    comm=comm)
            rgb = out["rgb"].detach()
            err = torch.sum(torch.abs(rgb - target), dim=-1)  # gf_pipeline:179
            if comm is not None:
                metrics = _whole_batch_metrics(
                    comm, losses, whole_terms, rgb, target, samples,
                    sampler_cfg.max_hits, r_all)
                metrics.update(grad_norms)
                return new_state, oct_dev, metrics, err
            mse = torch.mean((rgb - target) ** 2)
            metrics = {
                "loss": total.detach(),
                **{k: v.detach() for k, v in losses.items()},
                "psnr": -10.0 * torch.log10(mse + 1e-12),
                "num_samples_per_ray": samples.num_valid.float().mean(),
                **grad_norms,
            }
            if samples.num_hits is not None:
                # rays whose farthest leaf hits the max_hits top-k dropped
                metrics["frac_truncated_rays"] = (
                    samples.num_hits > sampler_cfg.max_hits).float().mean()
        return new_state, oct_dev, metrics, err

    return train_step


def _whole_batch_metrics(comm, losses: dict, whole_terms: tuple,
                         rgb: torch.Tensor, target: torch.Tensor, samples,
                         max_hits: int, r_all: int) -> dict:
    """The data-parallel step's metrics, the whole batch's on every rank,
    in one all-reduce: the ranks' shares of each ray term, the squared
    error, the valid samples and the truncated rays summed; the terms in
    ``whole_terms`` (already the whole batch's) as they are."""
    shared = [k for k in losses if k not in whole_terms]
    sums = [losses[k].detach().float() for k in shared]
    sums += [torch.sum((rgb - target) ** 2),
             samples.num_valid.float().sum()]
    if samples.num_hits is not None:
        sums.append((samples.num_hits > max_hits).float().sum())
    sums = comm.all_reduce(torch.stack(sums))
    terms = {k: (sums[shared.index(k)] if k in shared
                 else losses[k].detach()) for k in losses}
    n = len(shared)
    metrics = {"loss": sum(terms.values()), **terms,
               "psnr": -10.0 * torch.log10(sums[n] / (3 * r_all) + 1e-12),
               "num_samples_per_ray": sums[n + 1] / r_all}
    if samples.num_hits is not None:
        metrics["frac_truncated_rays"] = sums[n + 2] / r_all
    return metrics
