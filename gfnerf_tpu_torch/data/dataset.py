"""Image dataset and host-side image cache.

Port of ``gfnerf_tpu/data/dataset.py`` (nerfstudio's ``InputDataset`` and
``CacheDataloader``): images come from the dataparser's in-memory
``images_array``, road masks (the semantic labels) from its
``road_masks_array``; error maps (``.npy``) from the files the pipeline
writes at the stage transition.  The cache holds a sampled subset of the
images, resampled every ``num_times_to_repeat`` batches, and takes live
error-map writes.  Decoding images from disk (``imageio``/``cv2``) is not
ported.
"""

from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import DataparserOutputs


class InputDataset:
    """Per-image access to pixels and error maps (base_dataset.py:41-182)."""

    def __init__(self, dataparser_outputs: DataparserOutputs):
        self.outputs = dataparser_outputs
        self.cameras = dataparser_outputs.cameras
        self.metadata = dataparser_outputs.metadata
        self._images_array = self.metadata.get("images_array")

    def __len__(self):
        return len(self.outputs.image_filenames)

    def get_image(self, idx: int) -> np.ndarray:
        if self._images_array is None:
            raise NotImplementedError(
                "loading images from disk is not ported: the dataparser must "
                "provide metadata['images_array']")
        img = self._images_array[idx]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.asarray(img[..., :3], np.float32)

    def get_data(self, idx: int) -> Dict:
        """Image, its global index, and its road mask and error map, if
        any."""
        data = {"image": self.get_image(idx), "image_idx": idx}
        gii = self.metadata.get("global_image_indices")
        data["rel_camera_idx"] = gii[idx] if gii else idx
        masks = self.metadata.get("road_masks_array")
        if masks is not None:
            data["road_mask"] = np.asarray(masks[idx], np.float32)
        files = self.metadata.get("error_map_filenames")
        if files is not None and files[idx] is not None:
            p = Path(files[idx])
            if p.exists():
                data["error_map"] = np.load(p).astype(np.float32).squeeze()
        return data


class ImageCache:
    """Thread-pooled cache of up to N images (CacheDataloader semantics).

    Holds images (and error maps) for a sampled subset of the dataset,
    resampled every ``num_times_to_repeat`` batches.
    """

    def __init__(self, dataset: InputDataset,
                 num_images_to_sample_from: int = -1,
                 num_times_to_repeat: int = -1,
                 num_workers: int = 8,
                 seed: int = 0):
        self.dataset = dataset
        n = len(dataset)
        self.sample_all = (num_images_to_sample_from < 0
                           or num_images_to_sample_from >= n)
        self.num_images = n if self.sample_all else num_images_to_sample_from
        self.num_times_to_repeat = num_times_to_repeat
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)
        self._count = 0
        self.indices: np.ndarray = None  # dataset indices of cached images
        self.images: np.ndarray = None   # (K, H, W, 3) float32
        self.rel_camera_idx: np.ndarray = None
        self.road_masks: Optional[np.ndarray] = None  # (K, H, W) labels
        self.error_maps: Optional[np.ndarray] = None  # (K, H, W)
        self._reload()

    def _reload(self):
        n = len(self.dataset)
        if self.sample_all:
            idx = np.arange(n)
        else:
            idx = self._rng.choice(n, size=self.num_images, replace=False)
        self.indices = idx
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            datas = list(ex.map(lambda i: self.dataset.get_data(int(i)), idx))
        self.images = np.stack([d["image"] for d in datas])
        self.rel_camera_idx = np.asarray(
            [d["rel_camera_idx"] for d in datas], np.int32)
        self.road_masks = None
        if any("road_mask" in d for d in datas):
            h, w = self.images.shape[1:3]
            ms = []
            for d in datas:
                m = d.get("road_mask")
                if m is None:
                    m = np.zeros((h, w), np.float32)
                elif m.ndim == 3:
                    m = m[..., 0]
                ms.append(m.astype(np.float32))
            self.road_masks = np.stack(ms)
        self.error_maps = None
        if any("error_map" in d for d in datas):
            h, w = self.images.shape[1:3]
            ems = []
            for d in datas:
                em = d.get("error_map")
                if em is None:
                    em = np.ones((h, w), np.float32)
                elif em.shape != (h, w):
                    raise NotImplementedError(
                        f"an error map of shape {em.shape} for images of "
                        f"{(h, w)}: resizing (cv2) is not ported")
                ems.append(em.astype(np.float32))
            self.error_maps = np.stack(ems)

    def step(self):
        """Advance the repeat counter; periodically resample the cached set."""
        self._count += 1
        if (not self.sample_all and self.num_times_to_repeat > 0
                and self._count % self.num_times_to_repeat == 0):
            self._reload()

    def update_error_map(self, ray_indices: np.ndarray, values: np.ndarray):
        """Write fresh |error| values at sampled pixels
        (CacheDataloader._update_error_map, dataloaders.py:140-142)."""
        if self.error_maps is None:
            return
        k, y, x = ray_indices[:, 0], ray_indices[:, 1], ray_indices[:, 2]
        self.error_maps[k, y, x] = values
