"""Image dataset and host-side image cache.

Port of ``gfnerf_tpu/data/dataset.py`` (nerfstudio's ``InputDataset`` and
``CacheDataloader``): images come from the dataparser's in-memory
``images_array`` (the minimal parser's npz) or from the image files it
names, decoded by ``utils/image_io.py`` (PNG on ``zlib``, JPEG by the
port's codec on every device, other formats through ``imageio`` where it
imports); road masks (the semantic labels)
from ``road_masks_array`` or from files; depth (``.npy``), all-masks and
error maps from ``.npy`` or image files.  The cache holds a sampled
subset of the images, resampled every ``num_times_to_repeat`` batches,
and takes live error-map writes; an error map of another size is resized
to the images' (``cv2.INTER_LINEAR``'s rule, ``image_io.resize_linear``).

Unlike the JAX package, which leaves 16-bit images in [0, 65535], the
port divides them by 65535.
"""

from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import DataparserOutputs
from gfnerf_tpu_torch.utils.image_io import (read_image, resize_area,
                                             resize_linear)


def _load_image(path: Path, scale_factor: float = 1.0,
                alpha_color: Optional[str] = None) -> np.ndarray:
    """An image file as float32 (H, W, 3) in [0, 1]: uint8 over 255,
    uint16 over 65535; resized by ``scale_factor`` (area averaging, before
    the channels are fixed, as the JAX package does); grey repeated to
    three channels; RGBA composited over ``alpha_color`` (white when it is
    None or "white", else black)."""
    img = np.asarray(read_image(path))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if scale_factor != 1.0:
        img = resize_area(img, scale_factor)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4]
        bg = 1.0 if alpha_color in (None, "white") else 0.0
        img = img[..., :3] * alpha + bg * (1 - alpha)
    return img[..., :3]


class InputDataset:
    """Per-image access to pixels and side channels
    (base_dataset.py:41-182)."""

    def __init__(self, dataparser_outputs: DataparserOutputs,
                 scale_factor: float = 1.0):
        self.outputs = dataparser_outputs
        self.scale_factor = scale_factor
        self.cameras = dataparser_outputs.cameras
        self.metadata = dataparser_outputs.metadata
        self._images_array = self.metadata.get("images_array")
        self.alpha_color = self.metadata.get("alpha_color")

    def __len__(self):
        return len(self.outputs.image_filenames)

    def get_image(self, idx: int) -> np.ndarray:
        if self._images_array is not None:
            img = self._images_array[idx]
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            return np.asarray(img[..., :3], np.float32)
        return _load_image(self.outputs.image_filenames[idx],
                           self.scale_factor, self.alpha_color)

    def get_data(self, idx: int) -> Dict:
        """Image, its global index, and its side channels where the
        dataparser names them (base_dataset.py:105-158): depth, road mask,
        all-mask and error map, each from a ``.npy`` or an image file."""
        data = {"image": self.get_image(idx), "image_idx": idx}
        md = self.metadata
        masks = md.get("road_masks_array")
        if masks is not None:
            data["road_mask"] = np.asarray(masks[idx], np.float32)
        gii = md.get("global_image_indices")
        data["rel_camera_idx"] = gii[idx] if gii else idx
        for key, name in (("depth_filenames", "depth"),
                          ("road_mask_filenames", "road_mask"),
                          ("all_mask_filenames", "all_mask"),
                          ("error_map_filenames", "error_map")):
            files = md.get(key)
            if files is None or files[idx] is None:
                continue
            p = Path(files[idx])
            if p.suffix == ".npy" and p.exists():
                data[name] = np.load(p).astype(np.float32).squeeze()
            elif p.exists():
                data[name] = _load_image(p, self.scale_factor)
        return data


class ImageCache:
    """Thread-pooled cache of up to N images (CacheDataloader semantics):
    the pool's threads decode at once (the JPEG codec's C calls and zlib
    run without the GIL).

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
                    em = resize_linear(em, (w, h))
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
