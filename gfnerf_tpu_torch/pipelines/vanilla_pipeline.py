"""Vanilla pipeline for the stock model families.

Port of ``gfnerf_tpu/pipelines/vanilla_pipeline.py`` (nerfstudio's
``base_pipeline.py::VanillaPipeline``): one image cache over the train
views, a uniform pixel sampler, one model and single-stage training.  A
step is the loss, its backward, then one Adam over all the parameters at
``exponential_decay(lr_init -> lr_final over max_steps)`` with eps 1e-15
(optax's ``adam``: the port's ``PerGroupAdam`` with one group, every
update applied).  Eval renders whole images in chunks; checkpoints hold
the model, the optimizer state, the step and the draws' generator through
``torch.save``, and the pixel sampler's state, so that a resumed run takes
the batches the uninterrupted one would have taken.

Ported kinds: "nerfacto", "semantic-nerfw", "instant-ngp",
"vanilla-nerf", "mipnerf", "tensorf", "neus", "nerfplayer-nerfacto" and
"nerfplayer-ngp" (``models/nerfacto.py``, ``models/semantic_nerfw.py``,
``models/instant_ngp.py``, ``models/tensorf.py``, ``models/neus.py``,
``models/nerfplayer.py``).  mip-NeRF trains on cones
whose radius comes from the rays' pixel area; its eval and render pass
none, so their cones have radius 1e-3, as the JAX package's do.  For
vanilla-nerf and mip-NeRF the step's PSNR, eval and render read the fine
level.  The nerfplayer pair takes each train camera's time from the
dataparser's ``metadata["times"]`` (zeros without them); eval and render
pass ``rel = 0`` for every ray, so every eval image and frame is rendered
at train camera 0's time and with its appearance, as in the JAX package.
instant-ngp's and nerfplayer-ngp's occupancy grids are updated
before every 16th step (``step % 16 == 0``); instant-ngp reports the
samples the grid kept (``num_samples_per_batch``) and, with
``dynamic_batch``, retargets
the rays a batch so that the kept samples approach
``target_num_samples``: a power of two within [256, the configured
batch].  Unlike the JAX package's, the port's checkpoint holds the grid
(a buffer of the model), so a resumed or evaluated run starts from the
trained grid and not from all ones.  The GF-NeRF pipeline's own options raise
here: early termination (``enable_early_term``, ``render --early-term``)
and block routing
(``render_camera``'s ``stage``, ``force_split_idx``); its config has no
error-map or early-termination field, so overriding one raises.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.cameras import (generate_rays,
                                              generate_rays_multi,
                                              get_image_coords)
from gfnerf_tpu_torch.data.dataset import ImageCache, InputDataset
from gfnerf_tpu_torch.data.pixel_samplers import PixelSampler
from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig, OptState,
                                                PerGroupAdam, apply_updates)
from gfnerf_tpu_torch.engine.schedulers import optax_exponential_decay
from gfnerf_tpu_torch.models import instant_ngp as ngp
from gfnerf_tpu_torch.models import nerfacto as nerfacto_mod
from gfnerf_tpu_torch.models import nerfplayer as npl
from gfnerf_tpu_torch.models import neus as neus_mod
from gfnerf_tpu_torch.models import semantic_nerfw as snw
from gfnerf_tpu_torch.models import tensorf as tensorf_mod
from gfnerf_tpu_torch.models.instant_ngp import InstantNGPConfig
from gfnerf_tpu_torch.models.nerfplayer import (NerfplayerConfig,
                                                NerfplayerNGPConfig)
from gfnerf_tpu_torch.models.neus import NeuSConfig
from gfnerf_tpu_torch.models.tensorf import TensoRFConfig
from gfnerf_tpu_torch.pipelines.pipeline import _opt_state_dict, compute_ssim
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ModelKind:
    """One model family of the vanilla pipeline: where its settings live,
    how its model is built, its loss, its render forward and its draws."""

    settings: str        # the VanillaPipelineConfig field of its settings
    per_image: bool      # the settings take the train images' count
    # (settings, seed, device, train metadata) -> model
    build: Callable
    # (model, rays, device batch, draws) -> (total, (losses, outputs))
    loss: Callable
    forward: Callable    # (model, o, d, rel) -> outputs, no jitter
    draw_counts: Callable  # settings -> the n of each (R, n + 1) draw
    two_level: bool = False  # outputs {"coarse": ..., "fine": ...}
    # (model, rays, generator, device) -> the draws after draw_counts'
    extra_draws: Optional[Callable] = None
    # an occupancy grid, updated before every 16th step: (its draws
    # (model, generator, device) -> tensors, its update (model, *draws))
    occupancy: Optional[Tuple[Callable, Callable]] = None


def _nerfacto_kind(settings: str, init, loss) -> ModelKind:
    return ModelKind(
        settings=settings, per_image=True,
        build=lambda c, seed, dev, meta: nerfacto_mod.NerfactoModel(
            c, *init(c, seed), dev),
        loss=loss, forward=nerfacto_mod.nerfacto_forward,
        draw_counts=lambda c: [*c.num_proposal_samples, c.num_nerf_samples])


def _coarse_fine(c) -> List[int]:
    return [c.num_coarse_samples, c.num_importance_samples]


KINDS = {
    "nerfacto": _nerfacto_kind(
        "nerfacto", nerfacto_mod.init_nerfacto_params,
        lambda m, rays, b, dr: nerfacto_mod.nerfacto_loss(
            m, rays["origins"], rays["directions"], b["rel_camera_indices"],
            b["image"], draws=dr)),
    "semantic-nerfw": _nerfacto_kind(
        "semantic_nerfw", snw.init_semantic_nerfw_params,
        lambda m, rays, b, dr: snw.semantic_nerfw_loss(
            m, rays["origins"], rays["directions"], b["rel_camera_indices"],
            b["image"], b.get("semantics"), draws=dr)),
    "instant-ngp": ModelKind(
        settings="instant_ngp", per_image=True,
        build=lambda c, seed, dev, meta: ngp.InstantNGPModel(
            c, *ngp.init_instant_ngp_params(c, seed), dev),
        loss=lambda m, rays, b, dr: ngp.instant_ngp_loss(
            m, rays["origins"], rays["directions"], b["image"],
            None if dr is None else dr[0]),
        forward=lambda m, o, d, rel: ngp.instant_ngp_forward(m, o, d),
        draw_counts=lambda c: [c.num_samples],
        occupancy=(lambda m, gen, dev: [ngp.occupancy_jitter(m.cfg, gen,
                                                             dev)],
                   ngp.update_occupancy)),
    "vanilla-nerf": ModelKind(
        settings="vanilla", per_image=False,
        build=lambda c, seed, dev, meta: nerfacto_mod.VanillaNerfModel(
            c, nerfacto_mod.init_vanilla_params(c, seed), dev),
        loss=lambda m, rays, b, dr: nerfacto_mod.vanilla_loss(
            m, rays["origins"], rays["directions"], b["image"], dr),
        forward=lambda m, o, d, rel: nerfacto_mod.vanilla_forward(m, o, d),
        draw_counts=_coarse_fine, two_level=True),
    # mip-NeRF trains on cones of the rays' pixel area; its render passes
    # none (cones of radius 1e-3), as the JAX package's does
    "mipnerf": ModelKind(
        settings="mipnerf", per_image=False,
        build=lambda c, seed, dev, meta: nerfacto_mod.MipNerfModel(
            c, nerfacto_mod.init_mipnerf_params(c, seed), dev),
        loss=lambda m, rays, b, dr: nerfacto_mod.mipnerf_loss(
            m, rays["origins"], rays["directions"], b["image"],
            rays["pixel_area"], dr),
        forward=lambda m, o, d, rel: nerfacto_mod.mipnerf_forward(m, o, d),
        draw_counts=_coarse_fine, two_level=True),
    "tensorf": ModelKind(
        settings="tensorf", per_image=True,
        build=lambda c, seed, dev, meta: tensorf_mod.TensoRFModel(
            c, tensorf_mod.init_tensorf_params(c, seed), dev),
        loss=lambda m, rays, b, dr: tensorf_mod.tensorf_loss(
            m, rays["origins"], rays["directions"], b["image"], dr),
        forward=lambda m, o, d, rel: tensorf_mod.tensorf_forward(m, o, d),
        draw_counts=lambda c: [c.num_coarse_samples, c.num_fine_samples]),
    "neus": ModelKind(
        settings="neus", per_image=True,
        build=lambda c, seed, dev, meta: neus_mod.NeuSModel(
            c, neus_mod.init_neus_params(c, seed), dev),
        loss=lambda m, rays, b, dr: neus_mod.neus_loss(
            m, rays["origins"], rays["directions"], b["image"], dr),
        forward=lambda m, o, d, rel: neus_mod.neus_forward(m, o, d),
        draw_counts=lambda c: [c.num_samples]),
    # each grid's TV window row follows the sampler's draws
    "nerfplayer-nerfacto": ModelKind(
        settings="nerfplayer", per_image=True,
        build=lambda c, seed, dev, meta: npl.NerfplayerModel(
            c, *npl.init_nerfplayer_params(c, seed, meta.get("times")), dev),
        loss=lambda m, rays, b, dr: npl.nerfplayer_loss(
            m, rays["origins"], rays["directions"], b["rel_camera_indices"],
            b["image"], *((None, None) if dr is None else (dr[:-1], dr[-1]))),
        forward=npl.nerfplayer_forward,
        draw_counts=lambda c: [*c.num_proposal_samples, c.num_nerf_samples],
        extra_draws=lambda m, r, gen, dev: [npl.tv_rows(m, gen, dev)]),
    # the stratification (R, S), then the grid's TV window row
    "nerfplayer-ngp": ModelKind(
        settings="nerfplayer_ngp", per_image=True,
        build=lambda c, seed, dev, meta: npl.NerfplayerNGPModel(
            c, *npl.init_nerfplayer_ngp_params(c, seed, meta.get("times")),
            dev),
        loss=lambda m, rays, b, dr: npl.nerfplayer_ngp_loss(
            m, rays["origins"], rays["directions"], b["rel_camera_indices"],
            b["image"], *((None, None) if dr is None else dr)),
        forward=npl.nerfplayer_ngp_forward,
        draw_counts=lambda c: [],
        extra_draws=lambda m, r, gen, dev: [
            torch.rand((r, m.cfg.num_samples), generator=gen, device=dev),
            npl.tv_rows(m, gen, dev)],
        occupancy=(lambda m, gen, dev: npl.occupancy_draws(m.cfg, gen, dev),
                   npl.update_ngp_occupancy)),
}
# (step, rays) -> the step's draws: nerfacto's, one uniform array per
# proposal level and one for the final resample
# (ray_samplers.proposal_sample); instant-ngp's and neus's, one (R, S + 1)
# array; vanilla-nerf's, mipnerf's and tensorf's, the coarse
# stratification (R, S_coarse + 1) and the resampling's (R, S_fine + 1);
# nerfplayer-nerfacto's, nerfacto's and then the grids' TV window rows
# (field first, int64); nerfplayer-ngp's, the stratification (R, S) and
# the grid's TV window row (1,)
VanillaDraws = Callable[[int, int], List[np.ndarray]]
# step -> the occupancy update's draws: instant-ngp's jitter (g, g, g, 3);
# nerfplayer-ngp's [jitter (g^3, 3), times (g^3,)]
OccupancyDraws = Callable[[int], object]


@dataclasses.dataclass
class VanillaPipelineConfig:
    model_kind: str = "nerfacto"
    train_num_rays_per_batch: int = 4096
    # the JAX package's DynamicBatchPipeline: rays a batch retargeted to a
    # sample count (only instant-ngp reports one)
    dynamic_batch: bool = False
    target_num_samples: int = 1 << 18
    eval_num_rays_per_chunk: int = 4096
    lr_init: float = 1e-2
    lr_final: float = 1e-4
    max_steps: int = 30000
    seed: int = 42
    nerfacto: nerfacto_mod.NerfactoConfig = dataclasses.field(
        default_factory=nerfacto_mod.NerfactoConfig)
    vanilla: nerfacto_mod.VanillaNerfConfig = dataclasses.field(
        default_factory=nerfacto_mod.VanillaNerfConfig)
    mipnerf: nerfacto_mod.MipNerfConfig = dataclasses.field(
        default_factory=nerfacto_mod.MipNerfConfig)
    tensorf: TensoRFConfig = dataclasses.field(default_factory=TensoRFConfig)
    neus: NeuSConfig = dataclasses.field(default_factory=NeuSConfig)
    instant_ngp: InstantNGPConfig = dataclasses.field(
        default_factory=InstantNGPConfig)
    nerfplayer: NerfplayerConfig = dataclasses.field(
        default_factory=NerfplayerConfig)
    nerfplayer_ngp: NerfplayerNGPConfig = dataclasses.field(
        default_factory=NerfplayerNGPConfig)
    semantic_nerfw: snw.SemanticNerfWConfig = dataclasses.field(
        default_factory=snw.SemanticNerfWConfig)

    def build(self, dataparser, base_dir, device="cuda",
              draws: Optional[VanillaDraws] = None, checkpoint=None,
              occupancy_draws: Optional[OccupancyDraws] = None):
        """The pipeline (``checkpoint`` is the Trainer's: the caller loads
        it with ``load_checkpoint_state``)."""
        return VanillaPipeline(self, dataparser, base_dir, device, draws,
                               occupancy_draws)


@dataclasses.dataclass
class VanillaState:
    """The model (updated in place by each step), the optimizer's state
    and the count of steps taken."""

    model: torch.nn.Module
    opt_state: OptState
    step: int = 0


class VanillaPipeline:
    def __init__(self, config: VanillaPipelineConfig, dataparser,
                 base_dir: Path, device="cuda",
                 draws: Optional[VanillaDraws] = None,
                 occupancy_draws: Optional[OccupancyDraws] = None):
        """``draws``: each step's uniform draws, ``occupancy_draws``
        instant-ngp's occupancy jitter (tests inject the JAX package's);
        None draws them from a ``torch.Generator`` seeded with
        ``config.seed``."""
        kind = config.model_kind
        if kind not in KINDS:
            raise NotImplementedError(
                f"model kind {kind!r} is not ported; ported: "
                f"{list(KINDS)}")
        self.config = config
        self.base_dir = Path(base_dir)
        self.device = torch.device(device)
        self.draws = draws
        self.occupancy_draws = occupancy_draws
        self.train_outputs = dataparser.get_dataparser_outputs("train")
        self.eval_outputs = dataparser.get_dataparser_outputs("val")
        self.train_dataset = InputDataset(self.train_outputs)
        self.eval_dataset = InputDataset(self.eval_outputs)
        self.cache = ImageCache(self.train_dataset, seed=config.seed)
        self.pixel_sampler = PixelSampler(config.train_num_rays_per_batch,
                                          seed=config.seed)
        self.cameras_dev = self.train_outputs.cameras.to_device(self.device)
        self.eval_cameras_dev = self.eval_outputs.cameras.to_device(
            self.device)
        n_images = len(self.train_outputs.cameras)
        self.kind = kind
        self.spec = KINDS[kind]
        mcfg = getattr(config, self.spec.settings)
        if self.spec.per_image:
            mcfg = dataclasses.replace(mcfg, num_images=n_images)
        self.model = self.spec.build(mcfg, config.seed, self.device,
                                     self.train_outputs.metadata)
        self.model_cfg = mcfg
        self.tx = PerGroupAdam(
            OptimizersConfig(adam_eps=1e-15),
            schedules={"all": optax_exponential_decay(
                config.lr_init, config.max_steps,
                config.lr_final / config.lr_init)},
            skip_nonfinite=False)
        self.state = VanillaState(model=self.model,
                                  opt_state=self.tx.init(self._params()))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)

    def _params(self) -> dict:
        return {"all": list(self.model.parameters())}

    # --------------------------------------------------------------- train ----

    def _device_batch(self, batch: dict) -> dict:
        """The batch on the device in one host-to-device copy (indices and
        labels as float32, exact below 2^24)."""
        cols = [batch["camera_indices"][:, None].astype(np.float32),
                batch["rel_camera_indices"][:, None].astype(np.float32),
                batch["coords"], batch["image"]]
        if "semantics" in batch:
            cols.append(batch["semantics"][:, None].astype(np.float32))
        dev = torch.from_numpy(np.concatenate(cols, axis=1)).to(self.device)
        out = {"camera_indices": dev[:, 0].long(),
               "rel_camera_indices": dev[:, 1].long(),
               "coords": dev[:, 2:4], "image": dev[:, 4:7]}
        if "semantics" in batch:
            out["semantics"] = dev[:, 7].long()
        return out

    def _step_draws(self, step: int, r: int) -> List[torch.Tensor]:
        """The step's draws: injected, or from the generator.
        nerfacto's: (R, n + 1) uniforms for each proposal level's n
        samples and the final resample's; instant-ngp's and neus's: (R, S
        + 1), the stratification; vanilla-nerf's, mipnerf's and tensorf's:
        the coarse stratification's and the resampling's; the nerfplayer
        pair's: see ``VanillaDraws``."""
        if self.draws is not None:
            return [torch.as_tensor(np.asarray(x), device=self.device)
                    for x in self.draws(step, r)]
        out = [torch.rand((r, n + 1), generator=self.generator,
                          device=self.device)
               for n in self.spec.draw_counts(self.model_cfg)]
        if self.spec.extra_draws is not None:
            out += self.spec.extra_draws(self.model, r, self.generator,
                                         self.device)
        return out

    def update_occupancy(self, step: int) -> None:
        """The occupancy grid's update with this step's draws (injected,
        or from the generator)."""
        draw, update = self.spec.occupancy
        if self.occupancy_draws is not None:
            got = self.occupancy_draws(step)
            draws = [torch.as_tensor(np.asarray(x), device=self.device)
                     for x in (got if isinstance(got, (list, tuple))
                               else [got])]
        else:
            draws = draw(self.model, self.generator, self.device)
        update(self.model, *draws)

    def loss(self, batch: dict, draws=None):
        """(total, (losses, outputs)) of the model's loss on a device
        batch."""
        with span("rays"):
            rays = generate_rays_multi(self.cameras_dev,
                                       batch["camera_indices"],
                                       batch["coords"])
        return self.spec.loss(self.model, rays, batch, draws)

    def get_train_loss_dict(self, step: int) -> dict:
        """One step; the metrics come back in one device-to-host copy.
        instant-ngp and nerfplayer-ngp: the grid is updated first at every
        16th step; instant-ngp with
        ``dynamic_batch`` the next batch's rays are retargeted after."""
        self.cache.step()
        batch = self._device_batch(self.pixel_sampler.sample(self.cache))
        draws = self._step_draws(step, batch["image"].shape[0])
        if self.spec.occupancy and step % ngp.OCC_UPDATE_EVERY == 0:
            self.update_occupancy(step)
        self.model.zero_grad(set_to_none=True)
        total, (losses, out) = self.loss(batch, draws)
        with span("backward"):
            total.backward()
        with span("optimizer"):
            params = self._params()
            updates, opt_state = self.tx.update(
                {"all": [p.grad for p in params["all"]]},
                self.state.opt_state, params)
            apply_updates(params, updates)
        self.state = VanillaState(model=self.model, opt_state=opt_state,
                                  step=self.state.step + 1)
        with torch.no_grad():
            rgb = (out["fine"] if self.spec.two_level else out)["rgb"]
            mse = torch.mean((rgb - batch["image"]) ** 2)
            metrics = {"loss": total.detach(),
                       **{k: v.detach() for k, v in losses.items()},
                       "psnr": -10.0 * torch.log10(mse + 1e-12)}
            if "keep_frac" in out:
                metrics["num_samples_per_batch"] = (
                    out["keep_frac"] * out["weights"].numel())
            host = torch.stack([v.float() for v in metrics.values()]).cpu()
        metrics = {k: float(v) for k, v in zip(metrics, host.numpy())}
        if self.config.dynamic_batch and "num_samples_per_batch" in metrics:
            self._retarget_batch_size(metrics["num_samples_per_batch"])
            metrics["num_rays_per_batch"] = \
                self.pixel_sampler.num_rays_per_batch
        return metrics

    def _retarget_batch_size(self, num_samples: float):
        """The JAX package's DynamicBatchPipeline rule (reference
        dynamic_batch.py:72-77): rays scaled by target / kept samples,
        rounded down to a power of two within [256, the configured
        batch]."""
        cur = self.pixel_sampler.num_rays_per_batch
        want = cur * self.config.target_num_samples / max(num_samples, 1.0)
        bucket = 1 << max(8, int(np.log2(max(want, 1.0))))
        bucket = min(bucket, self.config.train_num_rays_per_batch)
        if bucket != cur:
            self.pixel_sampler.set_num_rays_per_batch(bucket)

    def after_train_iteration(self, step: int):
        pass

    # ---------------------------------------------------------------- eval ----

    @torch.no_grad()
    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    rel_camera_index: int = 0) -> dict:
        """rgb, accumulation and depth of a chunk of rays (no jitter; for
        nerfacto the appearance of image ``rel_camera_index``, 0 as in the
        JAX package; instant-ngp through its grid; vanilla-nerf's and
        mip-NeRF's fine level, mip-NeRF's cones of radius 1e-3)."""
        rel = torch.full((rays_o.shape[0],), int(rel_camera_index),
                         dtype=torch.int64, device=rays_o.device)
        out = self.spec.forward(self.model, rays_o, rays_d, rel)
        if self.spec.two_level:
            out = out["fine"]
        return {k: out[k] for k in ("rgb", "accumulation", "depth")}

    def render_camera(self, cameras_host, cameras_dev, camera_idx: int,
                      step: int = 0, downscale: int = 1,
                      rel_camera_index: Optional[int] = None,
                      stage: Optional[int] = None,
                      force_split_idx: Optional[int] = None) -> dict:
        """Chunked full-image render of one camera (numpy (h, w, C)
        outputs).  ``stage`` and ``force_split_idx`` (GF-NeRF's block
        routing) raise."""
        if stage is not None or force_split_idx is not None:
            raise ValueError("block routing is a GF-NeRF pipeline option; "
                             "a vanilla pipeline has one model")
        h = int(cameras_host.height[camera_idx]) // downscale
        w = int(cameras_host.width[camera_idx]) // downscale
        coords = torch.as_tensor(get_image_coords(h, w) * downscale,
                                 device=self.device)
        rays = generate_rays(cameras_dev, camera_idx, coords)
        o = rays["origins"].reshape(-1, 3)
        d = rays["directions"].reshape(-1, 3)
        chunk = self.config.eval_num_rays_per_chunk
        rel = 0 if rel_camera_index is None else rel_camera_index
        outs = [self.render_rays(o[s:s + chunk], d[s:s + chunk], rel)
                for s in range(0, o.shape[0], chunk)]
        return {k: torch.cat([x[k] for x in outs]).reshape(h, w, -1)
                .cpu().numpy() for k in outs[0]}

    def enable_early_term(self, eps: Optional[float] = None) -> bool:
        raise ValueError("early-termination rendering is a GF-NeRF pipeline "
                         "option; render a vanilla pipeline without "
                         "--early-term")

    def get_eval_image_metrics_and_images(self, step: int, idx: int = 0):
        """PSNR and SSIM of one eval image, its render's rays/s and fps;
        images: gt | prediction side by side, and the depth."""
        idx = idx % len(self.eval_dataset)
        gt = self.eval_dataset.get_image(idx)
        t0 = time.perf_counter()
        out = self.render_camera(self.eval_outputs.cameras,
                                 self.eval_cameras_dev, idx, step)
        dt = time.perf_counter() - t0
        pred = out["rgb"]
        mse = float(np.mean((pred - gt) ** 2))
        metrics = {"psnr": -10.0 * np.log10(mse + 1e-12),
                   "ssim": compute_ssim(pred, gt),
                   "num_rays_per_sec": gt.shape[0] * gt.shape[1] / dt,
                   "fps": 1.0 / dt}
        images = {"img": np.concatenate([gt, pred], axis=1),
                  "depth": out["depth"]}
        return metrics, images

    def get_average_eval_image_metrics(self, step: int) -> dict:
        ms = [self.get_eval_image_metrics_and_images(step, i)[0]
              for i in range(len(self.eval_dataset))]
        return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}

    # ------------------------------------------------------- checkpointing ----

    def save_checkpoint_state(self, ckpt_dir, step: int):
        ckpt_dir = Path(ckpt_dir)
        torch.save({"model": self.model.state_dict(),
                    "opt_state": _opt_state_dict(self.state.opt_state),
                    "step": self.state.step,
                    "generator": self.generator.get_state()},
                   ckpt_dir / "state.pt")
        (ckpt_dir / "meta.json").write_text(json.dumps(
            {"step": step, "sample_tmp_dir": "",
             "pixel_sampler": self.pixel_sampler.rng.bit_generator.state,
             "num_rays_per_batch": self.pixel_sampler.num_rays_per_batch,
             "cache_count": self.cache._count}))

    def load_checkpoint_state(self, ckpt_dir) -> int:
        """Restore what ``save_checkpoint_state`` wrote (the model's
        tensors in place).  Returns the checkpoint's step."""
        ckpt_dir = Path(ckpt_dir)
        saved = torch.load(ckpt_dir / "state.pt", map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(saved["model"])
        self.state = VanillaState(model=self.model,
                                  opt_state=OptState(**saved["opt_state"]),
                                  step=saved["step"])
        self.generator.set_state(saved["generator"].cpu())
        meta = json.loads((ckpt_dir / "meta.json").read_text())
        self.pixel_sampler.rng.bit_generator.state = meta["pixel_sampler"]
        self.pixel_sampler.set_num_rays_per_batch(meta.get(
            "num_rays_per_batch", self.config.train_num_rays_per_batch))
        self.cache._count = meta["cache_count"]
        return int(meta["step"])
