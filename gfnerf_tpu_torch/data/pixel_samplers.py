"""Pixel samplers (host-side numpy).

Port of ``gfnerf_tpu/data/pixel_samplers.py``: uniform and patch sampling
(``PixelSampler``), the error-guided sampler (``ErrorPixelSampler``, 20%
of rays by multinomial over the live error map, the rest uniform) and the
equirectangular sampler (``EquirectangularPixelSampler``, rows drawn by
sin(theta)).  Each
produces (R, 3) integer indices (image in the cache, y, x) and the gathered
pixels (and, where the cache holds road masks, each pixel's label as
``semantics``): a fixed-shape host batch for the train step.  The JAX
package's class-weighted sampler draws as the uniform one does without
patches (its weights unused), so the uniform one stands in for it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gfnerf_tpu_torch.data.dataset import ImageCache


class PixelSampler:
    """Uniform sampler over all pixels of the cached images."""

    def __init__(self, num_rays_per_batch: int, patch_size: int = 1,
                 seed: int = 0):
        self.num_rays_per_batch = num_rays_per_batch
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)

    def set_num_rays_per_batch(self, n: int):
        self.num_rays_per_batch = n

    def sample_indices(self, cache: ImageCache) -> np.ndarray:
        k, h, w = cache.images.shape[:3]
        r = self.num_rays_per_batch
        if self.patch_size > 1:
            # patch corners, each emitting a contiguous patch_size^2 block
            ps = self.patch_size
            n_patches = r // (ps * ps)
            ki = self.rng.integers(0, k, n_patches)
            yi = self.rng.integers(0, h - ps, n_patches)
            xi = self.rng.integers(0, w - ps, n_patches)
            dy, dx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
            ks = np.repeat(ki, ps * ps)
            ys = (yi[:, None] + dy.ravel()[None]).ravel()
            xs = (xi[:, None] + dx.ravel()[None]).ravel()
            idx = np.stack([ks, ys, xs], axis=-1)
            if len(idx) < r:
                pad = self.sample_indices_uniform(cache, r - len(idx))
                idx = np.concatenate([idx, pad])
            return idx[:r]
        return self.sample_indices_uniform(cache, r)

    def sample_indices_uniform(self, cache: ImageCache, r: int) -> np.ndarray:
        k, h, w = cache.images.shape[:3]
        ki = self.rng.integers(0, k, r)
        yi = self.rng.integers(0, h, r)
        xi = self.rng.integers(0, w, r)
        return np.stack([ki, yi, xi], axis=-1)

    def sample(self, cache: ImageCache) -> Dict[str, np.ndarray]:
        return collate_batch(cache, self.sample_indices(cache))


class EquirectangularPixelSampler(PixelSampler):
    """Uniform-on-sphere sampling for equirectangular images (reference
    pixel_samplers.py sample_method_equirectangular): latitude rows are
    drawn with density proportional to sin(theta) -- y = acos(1-2u)/pi --
    so pole pixels are not oversampled; longitudes stay uniform."""

    def sample_indices(self, cache: ImageCache) -> np.ndarray:
        k, h, w = cache.images.shape[:3]
        r = self.num_rays_per_batch
        ki = self.rng.integers(0, k, r)
        u = self.rng.random(r)
        yi = np.minimum((np.arccos(1 - 2 * u) / np.pi * h).astype(np.int64),
                        h - 1)
        xi = self.rng.integers(0, w, r)
        return np.stack([ki, yi, xi], axis=-1)


class ErrorPixelSampler(PixelSampler):
    """Error-guided sampler (pixel_samplers.py:594-844).

    ``weighted_choice_ratio`` = 0.2 of the batch is drawn by multinomial over
    the flattened error map; the rest uniformly (:606-715).
    """

    weighted_choice_ratio = 0.2

    def sample_indices(self, cache: ImageCache) -> np.ndarray:
        r = self.num_rays_per_batch
        if cache.error_maps is None:
            return super().sample_indices(cache)
        k, h, w = cache.images.shape[:3]
        n_err = int(r * self.weighted_choice_ratio)
        weights = cache.error_maps.reshape(-1).astype(np.float64)
        total = weights.sum()
        if total <= 0:
            return super().sample_indices(cache)
        flat = self.rng.choice(len(weights), size=n_err, replace=False,
                               p=weights / total)
        ki, rem = np.divmod(flat, h * w)
        yi, xi = np.divmod(rem, w)
        err_idx = np.stack([ki, yi, xi], axis=-1)
        uni_idx = self.sample_indices_uniform(cache, r - n_err)
        return np.concatenate([err_idx, uni_idx]).astype(np.int64)


def collate_batch(cache: ImageCache, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Gather pixels and camera metadata for sampled indices.

    Returns a host batch: ray 'indices' (cache_img, y, x), rgb targets,
    camera indices into the split dataset, rel_camera_indices (global image
    ids feeding the appearance embedding, pixel_samplers.py:114) and,
    where the cache holds road masks, the pixels' int32 labels
    ("semantics").
    """
    ki, yi, xi = idx[:, 0], idx[:, 1], idx[:, 2]
    extra = {}
    if cache.road_masks is not None:
        extra["semantics"] = cache.road_masks[ki, yi, xi].astype(np.int32)
    return {
        **extra,
        "indices": idx.astype(np.int32),
        "image": cache.images[ki, yi, xi].astype(np.float32),
        "camera_indices": cache.indices[ki].astype(np.int32),
        "rel_camera_indices": cache.rel_camera_idx[ki].astype(np.int32),
        # pixel-center coords (y + .5, x + .5) for ray generation
        "coords": np.stack([yi + 0.5, xi + 0.5], axis=-1).astype(np.float32),
    }
