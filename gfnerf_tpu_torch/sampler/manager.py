"""Host-side PersSampler orchestration.

Port of ``gfnerf_tpu/sampler/manager.py`` (the reference's Python
``PersSampler``): owns the host octree and its device copy, calibrates the
march (``sample_l`` by trial marches through the port's ``sample_rays`` on
the device; ``max_hits`` by counting trial rays' leaf hits on the host),
schedules milestone subdivisions and periodic compaction (the reference does
this inside ``UpdateOctNodes``, PersSampler_cuda.cu:667-677), anneals the
march fineness, clusters the cameras and looks up a camera's split for eval.
The current :class:`SamplerConfig` is ``sampler_config``: the train and
render functions read it at each call, so a grown ``max_hits`` takes effect
at the next step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from gfnerf_tpu_torch.sampler import octree as octree_mod
from gfnerf_tpu_torch.sampler.clustering import spectral_equal_size_clustering
from gfnerf_tpu_torch.sampler.octree import (PersOctree, build_octree,
                                             proc_octree)
from gfnerf_tpu_torch.sampler.perssampler import (
    OctreeDevice,
    SamplerConfig,
    octree_from_device,
    octree_to_device,
    ray_march_fineness,
)


@dataclasses.dataclass
class PersSamplerManagerConfig:
    """Host-side sampler knobs (gfnerf/perssampler.py:48-76,
    gfnerf/nerfacto.py:223-227)."""

    split_dist_thres: float = 1.5
    sub_div_milestones: tuple = (2000, 4000, 6000, 8000, 10000)
    compact_freq: int = 1000
    global_near: float = 0.01
    scale_by_dis: bool = True
    bbox_levels: int = 10           # model passes bbox_levels=10 (nerfacto.py:223)
    sample_l: float = 1.0 / 256
    max_level: int = 16
    ray_march_init_fineness: float = 16.0
    ray_march_fineness_decay_end_iter: int = 10000
    max_samples: int = 1024
    node_capacity: int = 262144
    seed: int = 0
    vis_res_w: int = 128
    n_rand_pts: int = 32 * 32 * 32
    # calibrate sample_l at setup with a trial march, so that the slot
    # budget spans the visible scene at any scene scale
    auto_sample_l: bool = True
    auto_sample_l_fill: float = 0.75   # target slot use of the median ray
    # fast-march leaf hits per ray (top-k size), grown by trial-ray hit
    # counts at setup and after milestone rebuilds, up to the reference's
    # 1024-intersection bound (PersSampler_cuda.cu:7-9)
    max_hits: int = 64
    auto_max_hits: bool = True
    # the march the train and render functions take: "fast" (leaf-list) or
    # "scan" (sequential point location, the reference's own semantics);
    # the calibrations march with the fast march, as the JAX package's do
    march: str = "fast"


class PersSamplerManager:
    def __init__(
        self,
        c2w: np.ndarray,       # (N, 3, 4) train cameras
        intri: np.ndarray,     # (N, 3, 3)
        bounds: np.ndarray,    # (N, 2)
        config: PersSamplerManagerConfig,
        n_split_dataset: int,
        steps_per_split_dataset: int,
        steps_perssampler_init: int,
        device="cuda",
        tree: Optional[PersOctree] = None,
        sampler_config: Optional[SamplerConfig] = None,
    ):
        """``tree`` and ``sampler_config``: a checkpoint's octree and march
        config, taken as they are (no build, no calibration)."""
        self.cfg = config
        self.c2w = c2w
        self.intri = intri
        self.bounds = bounds
        self.n_split_dataset = n_split_dataset
        self.steps_per_split_dataset = steps_per_split_dataset
        self.steps_perssampler_init = steps_perssampler_init
        self.device = device

        # scale milestones / decay with init length (perssampler.py:98-100)
        scale = max(steps_perssampler_init // 30000, 1)
        self.milestones: List[int] = sorted(
            int(m * scale) for m in config.sub_div_milestones)
        self.decay_end_iter = int(
            config.ray_march_fineness_decay_end_iter * scale)

        self.tree: PersOctree = tree if tree is not None else build_octree(
            c2w, intri, bounds,
            max_depth=config.max_level,
            bbox_levels=config.bbox_levels,
            split_dist_thres=config.split_dist_thres,
            seed=config.seed,
            n_rand_pts=config.n_rand_pts,
            vis_res_w=config.vis_res_w,
            device=device,
        )
        self.n_volumes = self.tree.n_volumes
        self.capacity = config.node_capacity
        self.oct_dev: OctreeDevice = self._upload()
        self.cameras_labels: Optional[np.ndarray] = None
        if sampler_config is not None:
            self.sampler_config = sampler_config
            return

        sample_l = config.sample_l
        if config.auto_sample_l:
            sample_l = self._calibrate_sample_l(sample_l)
        self.sampler_config = SamplerConfig(
            max_samples=config.max_samples,
            sample_l=sample_l,
            scale_by_dis=config.scale_by_dis,
            global_near=config.global_near,
            locate_iters=config.max_level + 8,
            march=config.march,
            max_hits=self._calibrate_max_hits(config.max_hits),
        )

    def _upload(self) -> OctreeDevice:
        while self.tree.n_nodes > self.capacity:
            self.capacity *= 2
        return octree_to_device(self.tree, self.capacity, device=self.device)

    def _trial_rays(self, n_rays: int):
        """Random pixels through random train cameras (host numpy)."""
        rng = np.random.default_rng(self.cfg.seed)
        n_cams = len(self.c2w)
        ki = rng.integers(0, n_cams, n_rays)
        dirs = []
        for k in ki:
            fx, fy = self.intri[k, 0, 0], self.intri[k, 1, 1]
            cx, cy = self.intri[k, 0, 2], self.intri[k, 1, 2]
            px = rng.uniform(0, 2 * cx)
            py = rng.uniform(0, 2 * cy)
            d_cam = np.array([(px - cx) / fx, -(py - cy) / fy, -1.0])
            d = self.c2w[k, :3, :3] @ d_cam
            dirs.append(d / np.linalg.norm(d))
        return (self.c2w[ki, :, 3].astype(np.float32),
                np.stack(dirs).astype(np.float32))

    def _count_leaf_hits(self, n_rays: int = 512) -> np.ndarray:
        """Per-ray count of valid-leaf slab intersections (host numpy) —
        the quantity the fast march's max_hits top-k truncates."""
        o, d = self._trial_rays(n_rays)
        t = self.tree
        sel = t.is_leaf & (t.trans_idx >= 0)
        lc = t.centers[sel]
        ls = t.side_lens[sel]
        lo = lc - ls[:, None] * 0.5
        hi = lc + ls[:, None] * 0.5
        counts = np.zeros(n_rays, np.int64)
        inv = 1.0 / np.where(np.abs(d) < 1e-10,
                             np.where(d >= 0, 1e-10, -1e-10), d)
        for s0 in range(0, n_rays, 64):  # bound the (chunk, L, 3) buffer
            sl = slice(s0, min(s0 + 64, n_rays))
            t0 = (lo[None] - o[sl, None]) * inv[sl, None]
            t1 = (hi[None] - o[sl, None]) * inv[sl, None]
            near = np.maximum(np.max(np.minimum(t0, t1), -1),
                              self.cfg.global_near)
            far = np.min(np.maximum(t0, t1), -1)
            counts[sl] = (far > near).sum(axis=1)
        return counts

    def _calibrate_max_hits(self, max_hits0: int) -> int:
        """Grow max_hits to the trial-ray hit maximum (x1.25 headroom,
        pow2-rounded, capped at the reference's 1024 bound) so deep trees
        never silently truncate; never shrinks below the configured value."""
        if not self.cfg.auto_max_hits:
            return max_hits0
        need = int(self._count_leaf_hits().max() * 1.25) + 1
        h = max_hits0
        while h < need and h < 1024:
            h *= 2
        if h != max_hits0:
            print(f"[sampler] auto-calibrated max_hits: {max_hits0} -> {h} "
                  f"(trial max {need})")
        return h

    def _calibrate_sample_l(self, sample_l0: float, n_rays: int = 256,
                            iters: int = 6) -> float:
        """Trial-march a random pixel subset and grow sample_l until the
        median ray covers its leaf span within the slot budget; never
        shrinks it below the configured value."""
        from gfnerf_tpu_torch.models.gfnerf import sample_rays

        o_np, d_np = self._trial_rays(n_rays)
        o = torch.as_tensor(o_np, device=self.device)
        d = torch.as_tensor(d_np, device=self.device)
        ones = torch.ones((n_rays, self.cfg.max_samples), device=self.device)
        s = self.cfg.max_samples
        fill = self.cfg.auto_sample_l_fill
        sample_l = float(sample_l0)
        scfg = SamplerConfig(max_samples=s, sample_l=sample_l0,
                             scale_by_dis=self.cfg.scale_by_dis,
                             global_near=self.cfg.global_near)
        for _ in range(iters):
            # sample_l enters the march only as sample_l * fineness
            samples = sample_rays(self.oct_dev, o, d, ones,
                                  sample_l / sample_l0, scfg)
            med = float(np.median(samples.num_valid.cpu().numpy()))
            if med <= fill * s:
                break
            # saturated: the median ray wants more length; grow the step
            sample_l *= (med / (fill * s)) * 1.2
        if sample_l != sample_l0:
            print(f"[sampler] auto-calibrated sample_l: {sample_l0:.5f} -> "
                  f"{sample_l:.5f} (median slots {med:.0f}/{s})")
        return sample_l

    # ------------------------------------------------------------- march ----

    def fineness(self, step: int) -> float:
        """UpdateRayMarch (PersSampler.cpp:958-967)."""
        return ray_march_fineness(step, self.cfg.ray_march_init_fineness,
                                  self.decay_end_iter)

    # ------------------------------------------------- milestone rebuilds ----

    def maybe_rebuild(self, step: int) -> bool:
        """Milestone subdivision + periodic compaction
        (PersSampler::UpdateOctNodes tail, PersSampler_cuda.cu:667-677).
        Returns True if the device octree was replaced."""
        do_milestone = bool(self.milestones) and self.milestones[0] <= step
        do_compact = (step > 0 and step % self.cfg.compact_freq == 0)
        if not (do_milestone or do_compact):
            return False

        self.tree = octree_from_device(self.oct_dev, self.tree)
        while self.milestones and self.milestones[0] <= step:
            m = self.milestones.pop(0)
            self.tree = proc_octree(self.tree, compact=True, subdivide=True,
                                    brute_force=m <= 0)
            octree_mod.mark_invisible_nodes(
                self.tree, self.c2w, self._w2c(), self.intri, self.bounds)
            self.tree = proc_octree(self.tree, compact=True, subdivide=False,
                                    brute_force=False)
        if do_compact and not do_milestone:
            self.tree = proc_octree(self.tree, compact=True, subdivide=False,
                                    brute_force=False)

        self.oct_dev = self._upload()
        print(f"[sampler] {'milestone rebuild' if do_milestone else 'compact'}"
              f" @step {step}: n_nodes {self.tree.n_nodes}"
              f" (capacity {self.capacity})", flush=True)
        # a deeper tree lets rays cross more leaves: regrow the hit budget
        self.recalibrate_max_hits()
        return True

    def recalibrate_max_hits(self) -> bool:
        """Regrow the fast-march hit budget for the current tree (after a
        rebuild, or after loading a checkpointed tree). True if it changed."""
        new_h = self._calibrate_max_hits(self.sampler_config.max_hits)
        if new_h != self.sampler_config.max_hits:
            self.sampler_config = dataclasses.replace(
                self.sampler_config, max_hits=new_h)
            return True
        return False

    def load_tree(self, tree: PersOctree) -> None:
        """Replace the host tree (a checkpoint's) and upload it."""
        self.tree = tree
        self.oct_dev = self._upload()

    def _w2c(self) -> np.ndarray:
        n = len(self.c2w)
        w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        w2c[:, :3, :] = self.c2w
        return np.linalg.inv(w2c)[:, :3, :]

    # ------------------------------------------------------------ blocks ----

    def update_block_idxs(self, block_centers: np.ndarray):
        octree_mod.update_block_idxs(self.tree, block_centers)
        self.oct_dev = self._upload()

    def train_cameras_clustering(self, k: int):
        """Spectral equal-size clustering on pairwise camera distances
        (perssampler.py:216-242; distances = origin distances,
        perssampler.py:170-215)."""
        if self.cameras_labels is not None:
            raise RuntimeError("the cameras are clustered already")
        pos = self.c2w[:, :3, 3]
        dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        labels = spectral_equal_size_clustering(
            dist, nclusters=k, nneighbors=int(dist.shape[0] * 0.1),
            seed=1234)
        sizes = np.bincount(labels, minlength=k)
        if not (sizes > 0).all():
            raise RuntimeError(f"an empty camera cluster: sizes {sizes}")
        self.cameras_labels = labels.astype(np.int64)
        return labels

    # --------------------------------------------------------------- eval ----

    def cur_split_idx(self, step: int) -> int:
        """Training-time split index (perssampler.py:363-366)."""
        if step < self.steps_perssampler_init:
            return -1
        return ((step - self.steps_perssampler_init)
                // self.steps_per_split_dataset) % self.n_split_dataset

    def get_nearest_split_dataset(self, origin: np.ndarray):
        """Eval-time block + appearance lookup (perssampler.py:138-165)."""
        pos = self.c2w[:, :3, 3]
        dists = np.linalg.norm(pos - origin.reshape(1, 3), axis=1)
        nearest = int(np.argmin(dists))
        if self.cameras_labels is not None:
            return int(self.cameras_labels[nearest]), nearest
        # fall back to contiguous-chunk mapping (perssampler.py:246-263)
        n_per = max(len(pos) // self.n_split_dataset, 1)
        return min(nearest // n_per, self.n_split_dataset - 1), nearest
