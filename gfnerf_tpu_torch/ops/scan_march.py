"""The scan march (kernel M1) and its wrapper.

``scan_march(oct, rays_o, rays_d, noise, cfg)`` is the JAX package's
``get_samples`` (``gfnerf_tpu/sampler/perssampler.py:337``, with
``locate_points``, ``:236``): one sequential octree march per ray over the
S = noise.shape[1] slots.  On CPU tensors it runs the plain version,
``sampler.perssampler.get_samples``; on CUDA tensors it launches
``csrc/scan_march.cu`` (M1: a group of lanes marches each ray, the
anchor's projections held across slots, the outputs staged and written
coalesced) or raises.  There is no backward: the train step takes no
gradient through the samples.  ``scan_march.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.ops import build
from gfnerf_tpu_torch.sampler.perssampler import (OctreeDevice,
                                                  SamplerConfig, get_samples)


def scan_march(oct: OctreeDevice, rays_o: torch.Tensor, rays_d: torch.Tensor,
               noise: torch.Tensor, cfg: SamplerConfig) -> WarpedSamples:
    """The scan march of rays (R, 3) with per-slot noise (R, S) already
    times the fineness: the plain version for CPU tensors, M1 for CUDA
    tensors."""
    if rays_o.device.type == "cpu":
        return get_samples(oct, rays_o, rays_d, noise, cfg)
    return _scan_march_cuda(oct, rays_o, rays_d, noise, cfg)


scan_march.launches = 0


def _table(x: torch.Tensor, dtype, dev, name: str) -> torch.Tensor:
    if x.device != dev:
        raise ValueError(f"scan_march: octree table {name} is on "
                         f"{x.device}, the rays on {dev}")
    return x.to(dtype).contiguous()


def _scan_march_cuda(oct: OctreeDevice, rays_o, rays_d, noise,
                     cfg: SamplerConfig) -> WarpedSamples:
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError(f"scan_march: unsupported device {dev}")
    if noise.dim() != 2:
        raise ValueError(f"scan_march: noise must be (R, S), got "
                         f"{tuple(noise.shape)}")
    r, s = noise.shape
    for name, x, shape in (("rays_o", rays_o, (r, 3)),
                           ("rays_d", rays_d, (r, 3)),
                           ("noise", noise, (r, s))):
        if x.device != dev or x.dtype != torch.float32 or x.shape != shape:
            raise ValueError(f"scan_march: {name} must be f32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    o, d, nz = (x.contiguous() for x in (rays_o, rays_d, noise))
    f32, i32 = torch.float32, torch.int32
    tables = [_table(oct.centers, f32, dev, "centers"),
              _table(oct.side_lens, f32, dev, "side_lens"),
              _table(oct.childs, i32, dev, "childs"),
              _table(oct.is_leaf, torch.bool, dev, "is_leaf"),
              _table(oct.trans_idx, i32, dev, "trans_idx"),
              _table(oct.block_idx, i32, dev, "block_idx"),
              _table(oct.w2xz_flat, f32, dev, "w2xz_flat"),
              _table(oct.warp_weight_flat, f32, dev, "warp_weight_flat"),
              _table(oct.t_center, f32, dev, "t_center"),
              _table(oct.t_dis_summary, f32, dev, "t_dis_summary")]
    world = torch.empty((r, s, 3), dtype=f32, device=dev)
    warp = torch.empty_like(world)
    dists = torch.empty((r, s), dtype=f32, device=dev)
    ts = torch.empty_like(dists)
    trans, node, block = (torch.empty((r, s), dtype=i32, device=dev)
                          for _ in range(3))
    valid = torch.empty((r, s), dtype=torch.bool, device=dev)
    num_valid = torch.empty((r,), dtype=torch.int64, device=dev)
    first_oct = torch.empty((r,), dtype=f32, device=dev)
    outs = (world, warp, dists, ts, trans, node, block, valid, num_valid,
            first_oct)
    err = build.library().gfnerf_scan_march(
        o.data_ptr(), d.data_ptr(), nz.data_ptr(),
        *(t.data_ptr() for t in tables), *(t.data_ptr() for t in outs),
        r, s, int(oct.w2xz.shape[0]), int(cfg.locate_iters),
        float(np.float32(cfg.sample_l)), int(cfg.scale_by_dis),
        float(np.float32(cfg.global_near)), float(np.float32(cfg.global_far)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "gfnerf_scan_march")
    scan_march.launches += 1
    return WarpedSamples(world_pts=world, dists=dists, ts=ts,
                         trans_idx=trans, oct_idx=node, block_idx=block,
                         valid=valid, num_valid=num_valid,
                         first_oct_dis=first_oct, warp_pts=warp)

