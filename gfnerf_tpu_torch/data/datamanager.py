"""GF-NeRF data manager.

Port of ``gfnerf_tpu/data/datamanager.py`` (nerfstudio's
``GFNerfDataManager``, base_datamanager.py:541-993):

- the full train dataset and the "init" dataset, a linspaced subset of at
  most ``max_init_images`` cameras (:660-686);
- ``setup_train_split_oct`` (:783-861): on a split change, select the
  cameras of one cluster, attach the error maps the pipeline rendered at
  the transition, rebuild the image cache and pick the error-guided pixel
  sampler;
- ``next_train`` (:923-948): init or split cache, the ray batch with the
  sampled ray indices for the pipeline's error-map write-back
  (gf_pipeline.py:179-186), and ``focal_uniform_fraction``'s full-scene
  rays at the end of a focal batch;
- ``next_eval`` / ``next_eval_image``.

Images are resized by ``camera_res_scale_factor`` as they load, in every
dataset (train, init, eval and each split); unlike the JAX package, which
leaves the cameras at the parser's size, the cameras are scaled with
them (nerfstudio's ``rescale_output_resolution``: fx, fy, cx, cy times
the factor, the width and height truncated), so that a pixel of the
resized image is cast through its own intrinsics.  With
``semantic_sample_weights`` a focal split draws uniformly without patches,
as the JAX package's class-weighted sampler does.

Host side: numpy image caches and samplers; a batch is a dict of
fixed-shape numpy arrays.  The concurrent focal stage of multi-card
training activates several clusters' splits at once
(``setup_train_splits_parallel``) and draws one batch from each
(``next_train_parallel``).  In multi-card training every rank runs the same
datamanager from the same seed and makes the same batches.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (CamerasHost,
                                                    DataparserOutputs)
from gfnerf_tpu_torch.data.dataset import ImageCache, InputDataset
from gfnerf_tpu_torch.data.pixel_samplers import (
    ErrorPixelSampler,
    PixelSampler,
    collate_batch,
)


@dataclasses.dataclass
class GFNerfDataManagerConfig:
    n_split_dataset: int = 10
    steps_per_split_dataset: int = 10000
    steps_perssampler_init: int = 30000
    train_num_rays_per_batch: int = 8192
    eval_num_rays_per_batch: int = 2048
    train_num_images_to_sample_from: int = 500
    train_num_times_to_repeat_images: int = 1000
    patch_size: int = 1
    camera_res_scale_factor: float = 1.0
    max_init_images: int = 100000   # base_datamanager.py:662
    # the JAX package's class weights of the focal splits' sampler, which
    # it keeps unused: set, the splits draw without patches
    semantic_sample_weights: Optional[List[float]] = None
    # fraction of each focal batch drawn uniformly from the full (init)
    # dataset; these rays sit at the end of the batch (``n_split_rays``
    # marks the boundary) and stay out of the error-map write-back
    focal_uniform_fraction: float = 0.0


def rescale_cameras(outputs: DataparserOutputs,
                    scale: float) -> DataparserOutputs:
    """``outputs`` with its cameras scaled to images resized by ``scale``
    (nerfstudio's ``Cameras.rescale_output_resolution``); the same object
    at scale 1."""
    if scale == 1.0:
        return outputs
    c = outputs.cameras
    f32 = np.float32(scale)
    cameras = CamerasHost(
        camera_to_worlds=c.camera_to_worlds,
        fx=c.fx * f32, fy=c.fy * f32, cx=c.cx * f32, cy=c.cy * f32,
        width=(c.width * scale).astype(c.width.dtype),
        height=(c.height * scale).astype(c.height.dtype),
        distortion_params=c.distortion_params, camera_type=c.camera_type)
    return dataclasses.replace(outputs, cameras=cameras)


class GFNerfDataManager:
    def __init__(self, config: GFNerfDataManagerConfig, dataparser,
                 seed: int = 0):
        self.config = config
        self.dataparser = dataparser
        self.seed = seed
        self.split_idx = -1

        scale = config.camera_res_scale_factor
        self.train_dataparser_outputs: DataparserOutputs = rescale_cameras(
            dataparser.get_dataparser_outputs(split="train"), scale)
        self.eval_dataparser_outputs: DataparserOutputs = rescale_cameras(
            dataparser.get_dataparser_outputs(split="val"), scale)
        self.train_dataset = InputDataset(self.train_dataparser_outputs,
                                          scale)
        self.eval_dataset = InputDataset(self.eval_dataparser_outputs, scale)

        # init dataset: linspaced subset (base_datamanager.py:660-686)
        n_cameras = len(self.train_dataparser_outputs.cameras)
        k = min(n_cameras, config.max_init_images)
        init_indices = np.linspace(0, n_cameras - 1, k, dtype=np.int32)
        self.init_outputs = self.train_dataparser_outputs.select(init_indices)
        self.train_dataset_init = InputDataset(self.init_outputs, scale)

        self.setup_train()
        self.setup_eval()

    def setup_train(self):
        cfg = self.config
        self.init_cache = ImageCache(
            self.train_dataset_init,
            num_images_to_sample_from=cfg.train_num_images_to_sample_from,
            num_times_to_repeat=cfg.train_num_times_to_repeat_images,
            seed=self.seed)
        self.init_pixel_sampler = PixelSampler(
            cfg.train_num_rays_per_batch, cfg.patch_size, seed=self.seed)
        self.split_cache: Optional[ImageCache] = None
        self.split_pixel_sampler: Optional[PixelSampler] = None
        self.split_outputs: Optional[DataparserOutputs] = None

    def setup_eval(self):
        self.eval_cache = ImageCache(self.eval_dataset, seed=self.seed + 1)
        self.eval_pixel_sampler = PixelSampler(
            self.config.eval_num_rays_per_batch, seed=self.seed + 1)

    def _build_split(self, camera_labels: np.ndarray, cur_split_idx: int,
                     sample_tmp_dir: Optional[str],
                     num_rays_per_batch: Optional[int] = None):
        """(outputs, sel, cache, sampler) for one cluster's focal split,
        ``num_rays_per_batch`` rays a batch (the config's if None)."""
        cfg = self.config
        error_map_filenames = None
        if sample_tmp_dir is not None and os.path.isdir(sample_tmp_dir):
            npy_dir = Path(sample_tmp_dir) / "npy"
            error_map_filenames = [
                npy_dir / (os.path.basename(str(f)) + ".npy")
                for f in self.train_dataparser_outputs.image_filenames]

        sel = np.where(np.asarray(camera_labels).reshape(-1)
                       == cur_split_idx)[0]
        outputs = self.train_dataparser_outputs.select(sel)
        if error_map_filenames is not None:
            outputs.metadata["error_map_filenames"] = [
                error_map_filenames[i] for i in sel]
        cache = ImageCache(
            InputDataset(outputs, cfg.camera_res_scale_factor),
            num_images_to_sample_from=cfg.train_num_images_to_sample_from,
            num_times_to_repeat=cfg.train_num_times_to_repeat_images,
            seed=self.seed + cur_split_idx)
        n_rays = num_rays_per_batch or cfg.train_num_rays_per_batch
        if error_map_filenames is not None:
            sampler = ErrorPixelSampler(n_rays, seed=self.seed)
        else:
            # the JAX package's class-weighted sampler, which
            # semantic_sample_weights selects, draws as this one does
            # without patches, its weights unused
            patch = (1 if cfg.semantic_sample_weights is not None
                     else cfg.patch_size)
            sampler = PixelSampler(n_rays, patch, seed=self.seed)
        return outputs, sel, cache, sampler

    def setup_train_split_oct(self, camera_labels: Optional[np.ndarray],
                              cur_split_idx: int,
                              sample_tmp_dir: Optional[str]):
        """Switch the active focal split (base_datamanager.py:783-861)."""
        if self.split_idx == cur_split_idx:
            return
        if camera_labels is None:
            raise ValueError("a focal split needs the camera labels")
        self.split_idx = cur_split_idx
        (self.split_outputs, self._split_indices, self.split_cache,
         self.split_pixel_sampler) = self._build_split(
            camera_labels, cur_split_idx, sample_tmp_dir)

    def setup_train_splits_parallel(self, camera_labels: np.ndarray,
                                    split_indices: List[int],
                                    sample_tmp_dir: Optional[str],
                                    num_rays_per_group: int):
        """Activate several clusters' splits at once, one for each block
        group of the concurrent focal step; a split active already keeps
        its cache and sampler."""
        current = getattr(self, "_parallel_splits", {})
        self._parallel_splits = {
            s: current[s] if s in current else self._build_split(
                camera_labels, s, sample_tmp_dir, num_rays_per_group)
            for s in split_indices}

    def next_train_parallel(self, step: int,
                            split_indices: List[int]) -> List[Dict]:
        """One batch from each active split, in ``split_indices`` order.
        ``focal_uniform_fraction`` applies to each: the batch's tail is
        full-scene uniform rays, after ``n_split_rays``, the boundary of
        the group's error write-back."""
        cfg = self.config
        batches = []
        for s in split_indices:
            outputs, _, cache, sampler = self._parallel_splits[s]
            cache.step()
            batch = sampler.sample(cache)
            n_rays = batch["image"].shape[0]
            n_split = n_rays
            if cfg.focal_uniform_fraction > 0:
                n_mix = min(max(int(round(
                    cfg.focal_uniform_fraction * n_rays)), 0), n_rays - 1)
                if n_mix > 0:
                    n_split = n_rays - n_mix
                    self.init_cache.step()
                    mix_idx = self.init_pixel_sampler.sample_indices_uniform(
                        self.init_cache, n_mix)
                    mix = collate_batch(self.init_cache, mix_idx)
                    batch = {k: np.concatenate([batch[k][:n_split], mix[k]],
                                               axis=0)
                             for k in ("indices", "image", "camera_indices",
                                       "rel_camera_indices", "coords",
                                       "semantics")
                             if k in batch and k in mix}
            batch["n_split_rays"] = np.int32(n_split)
            batch["step"] = np.int32(step)
            batch["split_idx"] = np.int32(s)
            batch["_cache"] = cache
            batch["_outputs"] = outputs
            batches.append(batch)
        return batches

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        """Fixed-shape host ray batch (base_datamanager.py:923-948)."""
        cfg = self.config
        init_stage = (cfg.steps_perssampler_init > 0
                      and step < cfg.steps_perssampler_init)
        if init_stage or self.split_cache is None:
            cache, sampler = self.init_cache, self.init_pixel_sampler
            outputs = self.init_outputs
        else:
            cache, sampler = self.split_cache, self.split_pixel_sampler
            outputs = self.split_outputs
        cache.step()
        batch = sampler.sample(cache)
        n_split = batch["image"].shape[0]
        if (not init_stage and self.split_cache is not None
                and cfg.focal_uniform_fraction > 0):
            # full-scene uniform rays at the end of the batch, so that
            # residual rows shared with empty space elsewhere keep getting
            # a corrective gradient
            n_mix = int(round(cfg.focal_uniform_fraction
                              * cfg.train_num_rays_per_batch))
            n_mix = min(max(n_mix, 0), cfg.train_num_rays_per_batch - 1)
            if n_mix > 0:
                n_split = cfg.train_num_rays_per_batch - n_mix
                self.init_cache.step()
                mix_idx = self.init_pixel_sampler.sample_indices_uniform(
                    self.init_cache, n_mix)
                mix = collate_batch(self.init_cache, mix_idx)
                batch = {k: np.concatenate([batch[k][:n_split], mix[k]],
                                           axis=0)
                         for k in ("indices", "image", "camera_indices",
                                   "rel_camera_indices", "coords",
                                   "semantics")
                         if k in batch and k in mix}
        batch["n_split_rays"] = np.int32(n_split)
        batch["step"] = np.int32(step)
        batch["split_idx"] = np.int32(-1 if init_stage else self.split_idx)
        batch["_cache"] = cache          # for error-map writeback
        batch["_outputs"] = outputs      # cameras of the active dataset
        return batch

    def next_eval(self, step: int) -> Dict[str, np.ndarray]:
        batch = self.eval_pixel_sampler.sample(self.eval_cache)
        batch["step"] = np.int32(step)
        batch["_outputs"] = self.eval_dataparser_outputs
        return batch

    def next_eval_image(self, idx: int):
        """(camera index, full image) for image-metric eval."""
        idx = idx % len(self.eval_dataset)
        return idx, self.eval_dataset.get_data(idx)
