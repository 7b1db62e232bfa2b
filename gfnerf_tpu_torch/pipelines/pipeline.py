"""GF-NeRF pipeline: datamanager + sampler + field + optimizer state.

Port of ``gfnerf_tpu/pipelines/pipeline.py`` (``GFNerfPipeline``,
gf_pipeline.py:77-299, with the model's training callbacks,
nerfacto.py:323-520): host-side stage logic around the train and render
functions of ``models/gfnerf.py``, on one card or, in a process group of
several ranks (``torch.distributed``, :mod:`gfnerf_tpu_torch.parallel`), on
one card per rank.

- ``get_train_loss_dict``: the host batch, sent to the device in one copy;
  the stage's train step; at the focal stage the per-ray error written
  back into the active split's error maps (gf_pipeline.py:179-186); at the
  init stage the octree's milestone rebuilds and compaction.  The metrics
  (and at the focal stage the per-ray error) come back in one copy.
- ``after_train_iteration``: at the transition (init -> block) the error
  maps of every train view at 1/8 resolution (nerfacto.py:361-427), the
  camera clustering (nerfacto.py:354-359), the octree's block indices and,
  in finetune mode, every block table seeded with the global one; at every
  split change a fresh optimizer state and the split's datamanager.
- eval: per-ray block routing over an eval ray batch (the packed layout
  renders one chunked stream, each ray with its nearest camera's block;
  not on the proposal branch, which renders a stream per block); full
  images with PSNR, SSIM and the LPIPS proxy.
- checkpoints: the field, the optimizer state, the step and the march's
  random generator through ``torch.save``; the host octree, camera labels
  and milestones as the JAX package's npz.
- full-image renders (eval images, error maps, ``render.py``) optionally
  through the two-phase early-termination renderer (``eval_early_term``,
  ``enable_early_term``; not on the proposal branch).

Multi-card training (a process group of W > 1 ranks): every rank runs the
same host state from the same seed (the datamanager's batches, the
generator's draws; the octree and march config rank 0 builds, broadcast),
so that the host's decisions (rebuilds, clustering, splits) agree.  A
data-parallel step (the init stage, and the focal stage without
``parallel_blocks``) gives rank k the k-th of W slices of the batch and
equals the one-card step on the whole batch (``make_dp_train_step``); the
per-ray error is gathered, so every rank writes the same error maps.  The
transition's error-map renders are split over the ranks and gathered.
With ``parallel_blocks`` the ranks form a (data, block) grid
(``parallel.sharding.multihost_grid``): at the focal stage block group g
trains block g * B + phase (B = n_blocks / groups; the phase advances every
``steps_per_split_dataset`` steps) on its own cluster's rays, split over
its data ranks (``_train_parallel_block``); the groups' tables are
broadcast from each group's data rank 0 at each rotation and before an
eval or a checkpoint (``sync_block_tables``), after which every rank holds
every table bit for bit.

Not ported: the K-steps-per-dispatch scan (``steps_per_dispatch`` is kept
so that configs round-trip; one step runs per call) and the PNG previews
of the error maps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.cameras import (generate_rays,
                                              generate_rays_multi,
                                              get_image_coords)
from gfnerf_tpu_torch.data.datamanager import (GFNerfDataManager,
                                               GFNerfDataManagerConfig)
from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig, OptState,
                                                active_block_table,
                                                build_optimizer,
                                                field_param_groups)
from gfnerf_tpu_torch.fields.field import (STAGE_BLOCK, STAGE_INIT,
                                           FieldConfig, GFNeRFField,
                                           init_field_params)
from gfnerf_tpu_torch.model_components.lpips import lpips
from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig, TrainState,
                                            init_train_state, make_render_fn,
                                            make_train_step)
from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer
from gfnerf_tpu_torch.parallel import comm as parallel_comm
from gfnerf_tpu_torch.parallel.sharding import (block_axis, block_optimizer,
                                                make_parallel_block_step,
                                                multihost_grid)
from gfnerf_tpu_torch.sampler.manager import (PersSamplerManager,
                                              PersSamplerManagerConfig)
from gfnerf_tpu_torch.sampler.octree import PersOctree
from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

# (step, rays, samples) -> (march noise (R, S), S3IM permutations (9, R)),
# and on the proposal branch a third, the resampling's draws (R, K + 1)
Draws = Callable[[int, int, int], tuple]


@dataclasses.dataclass
class GFNerfPipelineConfig:
    datamanager: GFNerfDataManagerConfig = dataclasses.field(
        default_factory=GFNerfDataManagerConfig)
    model: GFNeRFModelConfig = dataclasses.field(
        default_factory=GFNeRFModelConfig)
    sampler: PersSamplerManagerConfig = dataclasses.field(
        default_factory=PersSamplerManagerConfig)
    optimizers: OptimizersConfig = dataclasses.field(
        default_factory=OptimizersConfig)
    field_log2_hashmap_size: int = 21
    field_num_levels: int = 16
    field_features_per_level: int = 2
    field_hash_layout: str = "anchored"   # "anchored" | "packed"
    field_packed_rows_log2: int = 15
    field_block_rows_log2: Optional[int] = None
    field_block_dense_levels: int = 0
    field_focal_mode: str = "residual"    # "residual" | "finetune"
    field_mlp_dtype: str = "float32"      # "float32" | "bfloat16"
    field_use_proposal: bool = False      # the proposal probe
    field_warp_mode: str = "pers"         # "identity": the ablation
    field_density_bias: float = 1.0
    field_proposal_levels: int = 4
    field_proposal_rows_log2: int = 12
    field_hidden_dim: int = 128
    field_hidden_dim_color: int = 128
    use_appearance_embedding: bool = True
    camera_opt_mode: str = "off"          # "off" | "SO3xR3" | "SE3"
    # False: focal splits sample pixels uniformly (the error maps are still
    # rendered)
    use_error_sampling: bool = True
    eval_num_rays_per_chunk: int = 2048
    # full-image renders (render_camera: eval images, error maps, render)
    # through the two-phase early-termination renderer
    # (models/render_early.py): within eval_early_term_eps of the single
    # pass; ignored for a background other than black
    eval_early_term: bool = False
    eval_early_term_eps: float = 5e-3
    camera_bounds: tuple = (0.01, 512.0)   # gf_pipeline.py:117-120
    seed: int = 42
    # multi-card training: train the focal residual tables concurrently on
    # a (data, block) grid of the ranks (parallel/sharding.py
    # make_parallel_block_step) instead of one block at a time; needs >= 2
    # ranks; the block axis takes min(n_blocks, the largest divisor of the
    # rank count that divides n_blocks)
    parallel_blocks: bool = False
    # block-axis size for parallel_blocks; 0 = auto
    parallel_block_axis: int = 0
    # the JAX package's K steps per dispatch; the port runs one step per
    # call whatever it says
    steps_per_dispatch: int = 1

    def build(self, dataparser, base_dir, device="cuda",
              draws: Optional[Draws] = None, checkpoint=None, comm=None):
        return GFNerfPipeline(self, dataparser, base_dir, device, draws,
                              checkpoint, comm)


def _opt_state_dict(s: OptState) -> dict:
    return {"count": s.count, "mu": s.mu, "nu": s.nu,
            "total_notfinite": s.total_notfinite,
            "last_finite": s.last_finite}


class GFNerfPipeline:
    def __init__(self, config: GFNerfPipelineConfig, dataparser,
                 base_dir: Path, device="cuda",
                 draws: Optional[Draws] = None, checkpoint=None, comm=None):
        """``draws``: the march noise and S3IM permutations of each step
        (tests inject the JAX package's; in a data-parallel step the whole
        batch's, in a concurrent focal step a rank's share's); None draws
        them from a ``torch.Generator`` seeded with ``config.seed``.
        ``checkpoint``: a checkpoint directory whose octree and march
        config the sampler takes instead of building and calibrating its
        own (the caller then loads the rest with
        ``load_checkpoint_state``).  ``comm``: the process group to train
        over (None: the world group ``initialize_multihost`` set up, if
        any; else one card)."""
        self.config = config
        self.base_dir = Path(base_dir)
        self.device = torch.device(device)
        self.draws = draws
        self.comm = comm if comm is not None else parallel_comm.world()
        mcfg = config.model
        if config.steps_per_dispatch > 1:
            print(f"[pipeline] steps_per_dispatch={config.steps_per_dispatch}"
                  " is not ported: one step per dispatch", file=sys.stderr)

        self.datamanager = GFNerfDataManager(config.datamanager, dataparser,
                                             seed=config.seed)
        cams = self.datamanager.train_dataparser_outputs.cameras
        n_cameras = len(cams)
        bounds = np.tile(np.asarray(config.camera_bounds, np.float32),
                         (n_cameras, 1))
        saved = (_read_host_state(checkpoint) if checkpoint is not None
                 else {})
        if self.comm is not None and checkpoint is None \
                and self.comm.rank != 0:
            # rank 0 builds and calibrates the octree once for every rank
            saved = self.comm.broadcast_object(None)
        self.sampler = PersSamplerManager(
            c2w=cams.camera_to_worlds,
            intri=cams.intrinsics_matrices(),
            bounds=bounds,
            config=config.sampler,
            n_split_dataset=mcfg.n_split_dataset,
            steps_per_split_dataset=mcfg.steps_per_split_dataset,
            steps_perssampler_init=mcfg.steps_perssampler_init,
            device=self.device,
            tree=saved.get("tree"),
            sampler_config=saved.get("sampler_config"),
        )
        if self.comm is not None and checkpoint is None \
                and self.comm.rank == 0:
            self.comm.broadcast_object(
                {"tree": self.sampler.tree,
                 "sampler_config": self.sampler.sampler_config})
        # block centers = every (n_cams/n_blocks)-th camera (nerfacto.py:232-241)
        step_n = max(n_cameras // mcfg.n_blocks, 1)
        self.block_centers = np.stack([
            cams.camera_to_worlds[min(i * step_n, n_cameras - 1), :, 3]
            for i in range(mcfg.n_blocks)])

        self.field_cfg = FieldConfig(
            num_images=n_cameras,
            hidden_dim=config.field_hidden_dim,
            hidden_dim_color=config.field_hidden_dim_color,
            log2_hashmap_size=config.field_log2_hashmap_size,
            num_levels=config.field_num_levels,
            features_per_level=config.field_features_per_level,
            n_blocks=mcfg.n_blocks,
            n_volumes=self.sampler.n_volumes,
            use_appearance_embedding=config.use_appearance_embedding,
            use_semantics=mcfg.use_semantics,
            camera_opt_mode=config.camera_opt_mode,
            hash_layout=config.field_hash_layout,
            packed_rows_log2=config.field_packed_rows_log2,
            block_rows_log2=config.field_block_rows_log2,
            block_dense_levels=config.field_block_dense_levels,
            focal_mode=config.field_focal_mode,
            mlp_dtype=config.field_mlp_dtype,
            use_proposal=config.field_use_proposal,
            warp_mode=config.field_warp_mode,
            density_bias=config.field_density_bias,
            proposal_levels=config.field_proposal_levels,
            proposal_rows_log2=config.field_proposal_rows_log2,
        )
        params, statics = init_field_params(self.field_cfg, seed=config.seed)
        self.field = GFNeRFField(self.field_cfg, params, statics,
                                 device=self.device)
        self.tx = build_optimizer(dataclasses.replace(
            config.optimizers,
            steps_perssampler_init=mcfg.steps_perssampler_init,
            steps_per_split_dataset=mcfg.steps_per_split_dataset,
            n_split_dataset=mcfg.n_split_dataset))
        self.state = init_train_state(self.field, self.tx)
        self._last_split_idx = -1
        self.cameras_dev = cams.to_device(self.device)
        self.eval_cameras_dev = (self.datamanager.eval_dataparser_outputs
                                 .cameras.to_device(self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.sample_tmp_dir: Optional[str] = None
        self._setup_grid()
        self._build_step_fns()

    def _setup_grid(self):
        """The ranks' (data, block) grid (pipeline.py:209-280 of the JAX
        package): with ``parallel_blocks`` and more than one block, the
        block axis ``parallel.sharding.block_axis`` gives; each block
        group's data ranks form a group of their own, over which its
        concurrent focal step averages."""
        config, mcfg, comm = self.config, self.config.model, self.comm
        self.grid = None
        self.n_block_axis = 1
        self._parallel = False
        if comm is None:
            return
        rays = config.datamanager.train_num_rays_per_batch
        if rays % comm.size:
            raise ValueError(f"{rays} rays a batch do not split over "
                             f"{comm.size} ranks")
        if config.parallel_blocks and mcfg.n_blocks > 1:
            self.n_block_axis = block_axis(comm.size, mcfg.n_blocks,
                                           config.parallel_block_axis)
        self.grid = multihost_grid(comm.size, comm.n_hosts,
                                   self.n_block_axis)
        self._parallel = self.n_block_axis > 1
        if not self._parallel:
            return
        if mcfg.num_proposal_resamples > 0:
            raise ValueError("parallel_blocks: the concurrent focal step "
                             "has no proposal branch (neither has the JAX "
                             "package's)")
        # every rank makes every group, in one order
        groups = [comm.new_group(self.grid.data_ranks(g))
                  for g in range(self.n_block_axis)]
        self._data_index, self._block_group = self.grid.coords(comm.rank)
        self._data_comm = groups[self._block_group]
        self._tx_block = block_optimizer()
        self._opt_blocks = None      # (block, its Adam state)
        # the (group, block) tables trained since the last sync, and the
        # phase whose first step synced them
        self._unsynced_blocks: set = set()
        self._synced_phase = -1

    def _build_step_fns(self):
        """The train and render functions for the manager's current sampler
        config (``max_hits`` can grow after a milestone rebuild)."""
        mcfg = self.config.model
        scfg = self.sampler.sampler_config
        self._built_sampler_cfg = scfg
        # over several ranks, the data-parallel step (make_dp_train_step)
        self._train_step = {
            stage: make_train_step(mcfg, scfg, self.tx, stage, self.comm)
            for stage in (STAGE_INIT, STAGE_BLOCK)}
        if self._parallel:
            self._pb_step = make_parallel_block_step(
                mcfg, scfg, self._tx_block, self._data_comm)
        self._render_chunk = make_render_fn(mcfg, scfg)
        self._build_early_renderer()

    def _build_early_renderer(self):
        mcfg = self.config.model
        self._early_renderer = None
        if (self.config.eval_early_term
                and mcfg.num_proposal_resamples == 0
                and mcfg.background_color == "black"):
            self._early_renderer = EarlyTermRenderer(
                mcfg, self._built_sampler_cfg,
                eps=self.config.eval_early_term_eps)

    def enable_early_term(self, eps: Optional[float] = None) -> bool:
        """Render full images through the early-termination renderer from
        now on (``gfnerf_tpu_torch.render --early-term``).  Returns whether
        it is on: False (with a note on stderr) for a background other
        than black.  Raises ValueError on the proposal branch, which the
        renderer does not compose with."""
        if self.config.model.num_proposal_resamples > 0:
            raise ValueError(
                "early-termination rendering does not compose with proposal "
                "resampling (num_proposal_resamples > 0): render without "
                "--early-term")
        self.config.eval_early_term = True
        if eps is not None:
            self.config.eval_early_term_eps = eps
        self._build_early_renderer()
        if self._early_renderer is None:
            print("[pipeline] early-term rendering needs a black "
                  "background; keeping the single-pass renderer",
                  file=sys.stderr)
            return False
        return True

    # --------------------------------------------------------------- train ----

    def stage_of(self, step: int) -> int:
        mcfg = self.config.model
        init = (mcfg.steps_perssampler_init > 0
                and step < mcfg.steps_perssampler_init)
        return STAGE_INIT if init else STAGE_BLOCK

    def _device_batch(self, batch: dict) -> dict:
        """The step's batch on the device, in one host-to-device copy: the
        camera indices (and the semantic labels, if the batch has them)
        travel as float32, exact below 2^24."""
        cols = [batch["rel_camera_indices"][:, None].astype(np.float32),
                batch["coords"], batch["image"]]
        if "semantics" in batch:
            cols.append(batch["semantics"][:, None].astype(np.float32))
        dev = torch.from_numpy(np.concatenate(cols, axis=1)).to(self.device)
        cam = dev[:, 0].long()
        out = {"camera_indices": cam, "rel_camera_indices": cam,
               "coords": dev[:, 1:3], "image": dev[:, 3:6]}
        if "semantics" in batch:
            out["semantics"] = dev[:, 6].long()
        return out

    # ------------------------------------------- the concurrent focal stage ----

    def parallel_phase(self, step: int) -> int:
        """The rotation's phase: with B = n_blocks / block groups, phase p
        trains blocks {g * B + p : g} concurrently."""
        mcfg = self.config.model
        bps = mcfg.n_blocks // self.n_block_axis
        rel = max(step - mcfg.steps_perssampler_init, 0)
        return (rel // mcfg.steps_per_split_dataset) % bps

    def parallel_active_blocks(self, step: int) -> list:
        bps = self.config.model.n_blocks // self.n_block_axis
        p = self.parallel_phase(step)
        return [g * bps + p for g in range(self.n_block_axis)]

    def _train_parallel_block(self, step: int) -> Dict[str, float]:
        """One concurrent focal step (pipeline.py:355-400 of the JAX
        package): every rank draws every group's batch (the same host
        state everywhere), trains its group's block on its share of the
        group's rays, and gathers every group's loss and errors, which it
        writes into every group's error maps (cut at ``n_split_rays``).
        The splits of the step's blocks are activated here: the JAX
        pipeline activates those of the step just trained, after it, and
        fails at the first rotation.  The first step of a phase first
        syncs the tables the last phase trained."""
        phase = self.parallel_phase(step)
        if phase != self._synced_phase:
            self.sync_block_tables()
            self._synced_phase = phase
        blocks = self.parallel_active_blocks(step)
        self.datamanager.setup_train_splits_parallel(
            self.sampler.cameras_labels, blocks,
            self.sample_tmp_dir if self.config.use_error_sampling else None,
            self.config.datamanager.train_num_rays_per_batch)
        batches = self.datamanager.next_train_parallel(step, blocks)
        g, d = self._block_group, self._data_index
        block = blocks[g]
        mine = batches[g]
        r = len(mine["image"]) // self.grid.n_data
        dev_batch = self._device_batch(
            {k: mine[k][d * r:(d + 1) * r] for k in
             ("rel_camera_indices", "coords", "image")})
        noise = perms = None
        if self.draws is not None:
            noise, perms, *_ = self.draws(
                step, r, self.sampler.sampler_config.max_samples)
            noise = torch.as_tensor(noise, device=self.device)
            perms = torch.as_tensor(perms, device=self.device).long()
        if self._opt_blocks is None or self._opt_blocks[0] != block:
            # a fresh block Adam for a table it has not stepped
            self._opt_blocks = (block, self._tx_block.init(
                {"block": [active_block_table(self.field, block)]}))
        opt, loss, err = self._pb_step(
            self.field, self._opt_blocks[1], self.sampler.oct_dev,
            self.cameras_dev, dev_batch, self.sampler.fineness(step), block,
            generator=self.generator, noise=noise, s3im_perms=perms)
        self._opt_blocks = (block, opt)
        self._unsynced_blocks.update(enumerate(blocks))
        self.state = TrainState(field=self.field,
                                opt_state=self.state.opt_state,
                                step=self.state.step + 1)
        # every rank's loss and errors, in one gather and one copy
        rows = self.comm.all_gather(
            torch.cat([loss.reshape(1), err.float()])[None])
        rows = rows.cpu().numpy()
        losses = []
        for gi, (b, batch) in enumerate(zip(blocks, batches)):
            ranks = self.grid.data_ranks(gi)
            losses.append(rows[ranks[0], 0])
            cache = batch["_cache"]
            if cache.error_maps is not None:
                ns = int(batch["n_split_rays"])
                errs = np.concatenate([rows[k, 1:] for k in ranks])
                cache.update_error_map(batch["indices"][:ns], errs[:ns])
        losses = np.asarray(losses, np.float32)
        return {"loss": float(losses.mean()),
                **{f"block_{b}_loss": float(v)
                   for b, v in zip(blocks, losses)}}

    @torch.no_grad()
    def sync_block_tables(self) -> None:
        """Broadcast each block group's tables trained since the last sync
        from the group's data rank 0 (every rank calls it: at the first
        step of each phase, and before an eval or a checkpoint); after it
        every rank holds every table bit for bit.  A no-op off the
        concurrent focal stage."""
        if not self._parallel:
            return
        for g, b in sorted(self._unsynced_blocks):
            table = self.field.block_feats[b].detach().clone()
            self.comm.broadcast(table, src=self.grid.data_ranks(g)[0])
            # in place, through the parameter: its version moves, which
            # renews the stack's bf16 copy
            self.field.block_feats[b].copy_(table)
        self._unsynced_blocks.clear()

    def get_train_loss_dict(self, step: int) -> Dict[str, float]:
        stage = self.stage_of(step)
        if (stage == STAGE_BLOCK and self._parallel
                and self.sampler.cameras_labels is not None):
            return self._train_parallel_block(step)
        batch = self.datamanager.next_train(step)
        cache = batch.pop("_cache")
        batch.pop("_outputs")
        r = r_all = len(batch["image"])
        if self.comm is not None:
            # this rank's slice; the draws stay the whole batch's
            r = r_all // self.comm.size
            lo = self.comm.rank * r
            batch = {k: (v[lo:lo + r] if k in ("rel_camera_indices",
                                               "coords", "image",
                                               "semantics") else v)
                     for k, v in batch.items()}
        dev_batch = self._device_batch(batch)
        noise = perms = prop_u = None
        if self.draws is not None:
            noise, perms, *rest = self.draws(
                step, r_all, self.sampler.sampler_config.max_samples)
            noise = torch.as_tensor(noise, device=self.device)
            perms = torch.as_tensor(perms, device=self.device).long()
            if rest:
                prop_u = torch.as_tensor(rest[0], device=self.device)
        self.state, self.sampler.oct_dev, metrics, err = \
            self._train_step[stage](
                self.state, self.sampler.oct_dev, self.cameras_dev,
                dev_batch, self.sampler.fineness(step),
                generator=self.generator, noise=noise, s3im_perms=perms,
                active_block=max(self.sampler.cur_split_idx(step), 0),
                prop_u=prop_u)

        # one device-to-host copy: the metrics, and at the focal stage the
        # per-ray error of the split's rays (the mixed full-scene rays of
        # focal_uniform_fraction sit at the end and index another cache)
        names = list(metrics)
        host = [torch.stack([metrics[k].float() for k in names])]
        write_back = stage == STAGE_BLOCK and cache.error_maps is not None
        ns = int(batch["n_split_rays"])
        if write_back:
            if self.comm is not None:   # the whole batch's, every rank
                err = self.comm.all_gather(err.float())
            host.append(err[:ns].float())
        host = torch.cat(host).cpu().numpy()
        if write_back:
            cache.update_error_map(batch["indices"][:ns], host[len(names):])

        if stage == STAGE_INIT and self.sampler.maybe_rebuild(step) \
                and self.sampler.sampler_config \
                is not self._built_sampler_cfg:
            self._build_step_fns()
        return {k: float(v) for k, v in zip(names, host[:len(names)])}

    def after_train_iteration(self, step: int):
        """Stage-transition callbacks, in reference registration order
        (nerfacto.py:516-519): error maps -> clustering -> datamanager."""
        mcfg = self.config.model
        if self.stage_of(step) != STAGE_BLOCK:
            return
        if self.sampler.cameras_labels is None:
            self.render_init_error_maps(step)
            self.sampler.train_cameras_clustering(mcfg.n_blocks)
            self.sampler.update_block_idxs(self.block_centers)
            if (self.field_cfg.focal_mode == "finetune"
                    and self.field.block_feats is not None):
                # seed every block table with the trained global table once,
                # in place (the bf16 copy of the stack keys on its version)
                with torch.no_grad():
                    self.field.block_feats.copy_(
                        self.field.global_feat.expand_as(
                            self.field.block_feats))
        if self._parallel:
            # the JAX package's parallel branch (pipeline.py:559-571): a
            # fresh block Adam at each rotation (each step activates its
            # own splits, _train_parallel_block)
            phase = self.parallel_phase(step)
            if phase != self._last_split_idx:
                self._opt_blocks = None
                self._last_split_idx = phase
            return
        cur = self.sampler.cur_split_idx(step)
        if cur != self._last_split_idx:
            # a fresh optimizer state at each split activation (the
            # reference's add_optimizer/delete_optimizer swap,
            # nerfacto.py:448-489); all but the block table are frozen
            self.state = TrainState(
                field=self.field,
                opt_state=self.tx.init(field_param_groups(self.field)),
                step=self.state.step)
            self._last_split_idx = cur
        self.datamanager.setup_train_split_oct(
            self.sampler.cameras_labels, cur,
            self.sample_tmp_dir if self.config.use_error_sampling else None)

    # ---------------------------------------------------------------- eval ----

    def get_eval_loss_dict(self, step: int) -> Dict[str, float]:
        """Eval ray batch metrics (logged every steps_per_eval_batch).  Each
        camera's rays take the block and appearance of the train camera
        nearest to it: with the packed layout one chunked stream over the
        batch, a block per ray; otherwise (and on the proposal branch) one
        stream per (block, nearest camera) group."""
        batch = self.datamanager.next_eval(step)
        outputs = batch.pop("_outputs")
        cam_idx = batch["camera_indices"]
        coords = torch.as_tensor(batch["coords"], device=self.device)
        rays = generate_rays_multi(
            self.eval_cameras_dev,
            torch.as_tensor(cam_idx, dtype=torch.int64, device=self.device),
            coords)
        stage = self.stage_of(step)
        c2w = outputs.cameras.camera_to_worlds
        r = len(cam_idx)
        split_ray = np.zeros(r, np.int64)
        nearest_ray = np.zeros(r, np.int64)
        for cam in np.unique(cam_idx):
            sel = np.nonzero(cam_idx == cam)[0]
            split_idx, nearest = self.sampler.get_nearest_split_dataset(
                c2w[cam, :3, 3])
            split_ray[sel] = max(split_idx, 0)
            nearest_ray[sel] = nearest
        routed = (self.field_cfg.hash_layout == "packed"
                  and not self.field_cfg.use_proposal
                  and self.field_cfg.n_blocks > 0)
        if routed:
            groups = [(None, np.arange(r))]
        else:
            gmap: Dict[tuple, list] = {}
            for cam in np.unique(cam_idx):
                sel = np.nonzero(cam_idx == cam)[0]
                gmap.setdefault((int(split_ray[sel[0]]),
                                 int(nearest_ray[sel[0]])), []).append(sel)
            groups = [(k, np.concatenate(v)) for k, v in gmap.items()]
        chunk = self.config.eval_num_rays_per_chunk
        pred = torch.zeros((r, 3), device=self.device)
        nearest_dev = torch.as_tensor(nearest_ray, device=self.device)
        split_dev = torch.as_tensor(split_ray, device=self.device)
        for gkey, sel in groups:
            for start in range(0, len(sel), chunk):
                ids = torch.as_tensor(sel[start:start + chunk],
                                      device=self.device)
                if routed:
                    rel, ab = nearest_dev[ids], split_dev[ids]
                else:
                    rel, ab = gkey[1], gkey[0]
                out = self._render_chunk(
                    self.field, self.sampler.oct_dev, rays["origins"][ids],
                    rays["directions"][ids], rel, ab, stage == STAGE_BLOCK)
                pred[ids] = out["rgb"]
        mse = float(np.mean((pred.cpu().numpy() - batch["image"]) ** 2))
        return {"eval_rgb_mse": mse,
                "eval_psnr": -10.0 * np.log10(mse + 1e-12)}

    # ----------------------------------------------------------- rendering ----

    def render_camera(self, cameras_host, cameras_dev, camera_idx: int,
                      step: int, downscale: int = 1,
                      rel_camera_index: Optional[int] = None,
                      stage: Optional[int] = None,
                      force_split_idx: Optional[int] = None) -> dict:
        """Chunked full-image render of one camera (numpy (h, w, C)
        outputs; base_model.py:162-186), with the block of the train camera
        nearest to it (or ``force_split_idx``); through the
        early-termination renderer when ``eval_early_term`` is on."""
        h = int(cameras_host.height[camera_idx]) // downscale
        w = int(cameras_host.width[camera_idx]) // downscale
        coords = torch.as_tensor(get_image_coords(h, w) * downscale,
                                 device=self.device)
        rays = generate_rays(cameras_dev, camera_idx, coords)
        if stage is None:
            stage = self.stage_of(step)
        split_idx, nearest = self.sampler.get_nearest_split_dataset(
            cameras_host.camera_to_worlds[camera_idx, :3, 3])
        if force_split_idx is not None:
            split_idx = force_split_idx
        if rel_camera_index is None:
            rel_camera_index = nearest
        o = rays["origins"].reshape(-1, 3)
        d = rays["directions"].reshape(-1, 3)
        chunk = self.config.eval_num_rays_per_chunk
        render = (self._render_chunk if self._early_renderer is None
                  else self._early_renderer.render_chunk)
        outs = [render(
            self.field, self.sampler.oct_dev, o[s:s + chunk], d[s:s + chunk],
            int(rel_camera_index), max(split_idx, 0), stage == STAGE_BLOCK)
            for s in range(0, o.shape[0], chunk)]
        return {k: torch.cat([out[k] for out in outs]).reshape(h, w, -1)
                .cpu().numpy() for k in outs[0]}

    def render_init_error_maps(self, step: int):
        """Render all train views at 1/8 res with the init-stage field and
        save their |error| maps (nerfacto.py:361-427), which the focal
        splits' error-guided samplers read."""
        # each rank writes its own copy (rank 0 the checkpoint's)
        rank = 0 if self.comm is None else self.comm.rank
        sample_tmp = self.base_dir / ("sample_tmp" if rank == 0
                                      else f"sample_tmp_rank{rank}")
        self.sample_tmp_dir = str(sample_tmp)
        os.makedirs(sample_tmp / "npy", exist_ok=True)
        dm = self.datamanager
        cams = dm.train_dataparser_outputs.cameras
        filenames = dm.train_dataparser_outputs.image_filenames
        gii = dm.train_dataset.metadata["global_image_indices"]
        down = 8
        preds = self._render_views_split(
            lambda idx: self.render_camera(
                cams, self.cameras_dev, idx, step, downscale=down,
                rel_camera_index=gii[idx], stage=STAGE_INIT)["rgb"],
            [(int(cams.height[i]) // down, int(cams.width[i]) // down)
             for i in range(len(cams))])
        for idx in range(len(cams)):
            gt = dm.train_dataset.get_image(idx)  # (H, W, 3)
            h, w = gt.shape[:2]
            pred = preds[idx]
            # nearest upsample to full res (nerfacto.py:404-406)
            pred = pred.repeat(down, axis=0).repeat(down, axis=1)[:h, :w]
            if pred.shape[:2] != (h, w):
                ph, pw = pred.shape[:2]
                pred = np.pad(pred, ((0, h - ph), (0, w - pw), (0, 0)),
                              mode="edge")
            error = np.abs(gt - pred).sum(axis=-1)  # (H, W)
            base = os.path.basename(str(filenames[idx]))
            np.save(sample_tmp / "npy" / (base + ".npy"), error)

    def _render_views_split(self, render, sizes: list) -> list:
        """``render(i)`` ((h, w, 3) numpy) of every view i of ``sizes``:
        on one card all here; over several ranks rank k renders views k,
        k + W, ..., and one all-reduce of a zero-padded buffer gives every
        rank every render."""
        if self.comm is None:
            return [render(i) for i in range(len(sizes))]
        comm = self.comm
        offsets = np.cumsum([0] + [h * w * 3 for h, w in sizes])
        flat = torch.zeros(int(offsets[-1]), device=comm.device)
        for i in range(comm.rank, len(sizes), comm.size):
            flat[offsets[i]:offsets[i + 1]] = torch.as_tensor(
                render(i), device=comm.device).reshape(-1)
        flat = comm.all_reduce(flat).cpu().numpy()
        return [flat[offsets[i]:offsets[i + 1]].reshape(h, w, 3)
                for i, (h, w) in enumerate(sizes)]

    def get_eval_image_metrics_and_images(self, step: int, idx: int = 0):
        """PSNR, SSIM and the LPIPS proxy on one eval image
        (gf_pipeline.py:195-268, nerfacto.py:716-747)."""
        dm = self.datamanager
        cam_idx, data = dm.next_eval_image(idx)
        gt = data["image"]
        t0 = time.perf_counter()
        out = self.render_camera(dm.eval_dataparser_outputs.cameras,
                                 self.eval_cameras_dev, cam_idx, step)
        dt = time.perf_counter() - t0
        pred = out["rgb"]
        mse = float(np.mean((pred - gt) ** 2))
        metrics = {
            "psnr": -10.0 * np.log10(mse + 1e-12),
            "ssim": compute_ssim(pred, gt),
            # not comparable to pretrained-LPIPS tables
            # (model_components/lpips.py)
            "lpips_proxy": float(lpips(
                torch.as_tensor(pred, device=self.device),
                torch.as_tensor(gt, device=self.device))),
            "num_rays_per_sec": gt.shape[0] * gt.shape[1] / dt,
            "fps": 1.0 / dt,
        }
        images = {"img": np.concatenate([gt, pred], axis=1),
                  "depth": out["depth"], "accumulation": out["accumulation"]}
        return metrics, images

    def get_average_eval_image_metrics(self, step: int):
        n = len(self.datamanager.eval_dataset)
        all_metrics = [self.get_eval_image_metrics_and_images(step, i)[0]
                       for i in range(n)]
        return {k: float(np.mean([m[k] for m in all_metrics]))
                for k in all_metrics[0]}

    # ------------------------------------------------------- checkpointing ----

    def save_checkpoint_state(self, ckpt_dir, step: int):
        """The field, optimizer state, step and march generator via
        ``torch.save``; the host octree, labels and milestones as npz."""
        ckpt_dir = Path(ckpt_dir)
        torch.save({"field": self.field.state_dict(),
                    "opt_state": _opt_state_dict(self.state.opt_state),
                    "step": self.state.step,
                    "generator": self.generator.get_state()},
                   ckpt_dir / "state.pt")
        t = self.sampler.tree
        oct_dev = self.sampler.oct_dev

        def host(x):
            return x[:t.n_nodes].cpu().numpy()

        np.savez(
            ckpt_dir / "octree.npz",
            centers=t.centers, side_lens=t.side_lens, parents=t.parents,
            childs=t.childs, is_leaf=t.is_leaf,
            trans_idx=host(oct_dev.trans_idx), block_idx=t.block_idx,
            weight_stats=host(oct_dev.weight_stats),
            alpha_stats=host(oct_dev.alpha_stats),
            visit_cnt=host(oct_dev.visit_cnt),
            w2xz=t.w2xz, weight=t.weight, t_center=t.t_center,
            t_dis_summary=t.t_dis_summary, t_side_len=t.t_side_len,
            milestones=np.asarray(self.sampler.milestones, np.int64),
            cameras_labels=(self.sampler.cameras_labels
                            if self.sampler.cameras_labels is not None
                            else np.array([])),
            step=step,
        )
        (ckpt_dir / "meta.json").write_text(json.dumps(
            {"step": step, "sample_tmp_dir": self.sample_tmp_dir or "",
             "sampler_config": dataclasses.asdict(
                 self.sampler.sampler_config)}))

    def load_checkpoint_state(self, ckpt_dir) -> int:
        """Restore what ``save_checkpoint_state`` wrote; the field's tensors
        are written in place.  Returns the checkpoint's step."""
        ckpt_dir = Path(ckpt_dir)
        saved = torch.load(ckpt_dir / "state.pt", map_location=self.device,
                           weights_only=True)
        self.field.load_state_dict(saved["field"])
        self.state = TrainState(field=self.field,
                                opt_state=OptState(**saved["opt_state"]),
                                step=saved["step"])
        # a generator's state is a CPU byte tensor, whatever its device
        self.generator.set_state(saved["generator"].cpu())

        saved = _read_host_state(ckpt_dir)
        self.sampler.load_tree(saved["tree"])
        self.sampler.milestones = saved["milestones"]
        self.sampler.cameras_labels = saved["cameras_labels"]
        self.sample_tmp_dir = saved["sample_tmp_dir"]
        # the march config the run had (max_hits grows with the tree)
        self.sampler.sampler_config = saved["sampler_config"]
        if self.sampler.sampler_config != self._built_sampler_cfg:
            self._build_step_fns()
        return saved["step"]


def _read_host_state(ckpt_dir) -> dict:
    """The host side of a checkpoint that ``save_checkpoint_state`` wrote:
    the octree, milestones, camera labels, march config, error-map
    directory and step."""
    ckpt_dir = Path(ckpt_dir)
    data = np.load(ckpt_dir / "octree.npz")
    tree = PersOctree(
        centers=data["centers"], side_lens=data["side_lens"],
        parents=data["parents"], childs=data["childs"],
        is_leaf=data["is_leaf"], trans_idx=data["trans_idx"],
        block_idx=data["block_idx"],
        weight_stats=data["weight_stats"].astype(np.int64),
        alpha_stats=data["alpha_stats"].astype(np.int64),
        visit_cnt=data["visit_cnt"].astype(np.int64),
        w2xz=data["w2xz"], weight=data["weight"], t_center=data["t_center"],
        t_dis_summary=data["t_dis_summary"], t_side_len=data["t_side_len"])
    labels = data["cameras_labels"]
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    return {"tree": tree,
            "milestones": [int(m) for m in data["milestones"]],
            "cameras_labels": (labels.astype(np.int64) if labels.size
                               else None),
            "sampler_config": SamplerConfig(**meta["sampler_config"]),
            "sample_tmp_dir": meta["sample_tmp_dir"] or None,
            "step": int(meta["step"])}


def compute_ssim(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM (gaussian sigma 1.5, standard constants) in numpy."""
    from scipy.ndimage import gaussian_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mx = gaussian_filter(x, 1.5)
        my = gaussian_filter(y, 1.5)
        mxy = gaussian_filter(x * y, 1.5)
        mxx = gaussian_filter(x * x, 1.5)
        myy = gaussian_filter(y * y, 1.5)
        vx = mxx - mx ** 2
        vy = myy - my ** 2
        cov = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
            (mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
