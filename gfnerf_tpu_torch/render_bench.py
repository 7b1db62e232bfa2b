"""Render-throughput benchmark of the PyTorch port (novel-view serving).

Port of ``scripts/render_bench.py`` with the workload of
``scripts/profile_step.build_workload``: 48 ring cameras at 96x72 around
the synthetic sphere scene, the perspective octree built from them, and the
field of the bench's ``quality`` config (8 levels x 4 channels, 2^15 packed
rows of 128, bf16 MLPs, 384 march slots, fineness 1, ``sample_l``
calibrated as ``bench._calibrate_sample_l`` does) with random weights from
``init_field_params(seed)``.  It answers render requests as a viewer would
send them: a few training views through ``render_camera``, then full frames
from a virtual camera on the ring in chunks of rays, and prints one JSON
line:

  {"metric": "render_seconds_per_1080p_frame", "value": <median>,
   "frame_seconds": [...], "rays_per_sec": ..., "chunk": ..., "config": ...,
   "views": ..., "views_seconds": ..., "device": ...}

Run on a CUDA card:  python -m gfnerf_tpu_torch.render_bench [--profile]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.cameras import (Cameras, generate_rays,
                                              get_image_coords)
from gfnerf_tpu_torch.fields.field import (FieldConfig, GFNeRFField,
                                           init_field_params)
from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                            make_render_fn, sample_rays)
from gfnerf_tpu_torch.sampler.octree import build_octree
from gfnerf_tpu_torch.sampler.perssampler import (SamplerConfig,
                                                  octree_to_device)
from gfnerf_tpu_torch.utils.profiling import profile_device
from gfnerf_tpu_torch.utils.synthetic import ring_cameras

N_VIEWS = 4              # training views rendered before the frames
FRAME_WH = (1920, 1080)  # the timed frame's size
FRAMES = 5               # timed frames, after one warm-up frame
CHUNK = 32768            # rays per render chunk (scripts/render_bench.py)


def calibrate_sample_l(oct_dev, c2w, fx, fy, cx, cy, w, h, S, device,
                       n_rays=256, fill=0.7, iters=6):
    """Grow sample_l until the median trial ray covers its leaf span within
    ``fill`` of the S-slot budget (bench._calibrate_sample_l)."""
    rng = np.random.default_rng(1)
    ki = rng.integers(0, len(c2w), n_rays)
    xs = (rng.random(n_rays) * w - cx[ki]) / fx[ki]
    ys = (rng.random(n_rays) * h - cy[ki]) / fy[ki]
    d_cam = np.stack([xs, -ys, -np.ones(n_rays)], -1)
    d_w = np.einsum("rij,rj->ri", c2w[ki, :3, :3], d_cam)
    d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)
    o = torch.as_tensor(c2w[ki, :3, 3], dtype=torch.float32, device=device)
    d = torch.as_tensor(d_w, dtype=torch.float32, device=device)
    sample_l0 = sample_l = 1.0 / 256
    scfg = SamplerConfig(max_samples=S, sample_l=sample_l0)
    ones = torch.ones((n_rays, S), device=device)
    med = 0.0
    for _ in range(iters):
        # the step enters the march only as sample_l * fineness
        samples = sample_rays(oct_dev, o, d, ones, sample_l / sample_l0,
                              scfg)
        med = float(np.median(samples.num_valid.cpu().numpy()))
        if med <= fill * S:
            break
        sample_l *= (med / (fill * S)) * 1.2
    return sample_l, med


def build_workload(device="cuda", seed: int = 0):
    """The bench scene, octree and field of the quality config
    (profile_step.build_workload("quality")).

    Returns a dict: cameras (numpy c2w, fx, fy, cx, cy, w, h), tree,
    oct_dev, scfg, fcfg, mcfg, field, and "timings" (seconds per set-up
    step)."""
    timings = {}
    n_cams = 48
    c2w, fx, fy, cx, cy, w, h = ring_cameras(n_cams, img_wh=(96, 72))
    intri = np.zeros((n_cams, 3, 3), np.float32)
    intri[:, 0, 0], intri[:, 1, 1] = fx, fy
    intri[:, 0, 2], intri[:, 1, 2], intri[:, 2, 2] = cx, cy, 1
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (n_cams, 1))

    t0 = time.perf_counter()
    tree = build_octree(c2w, intri, bounds, max_depth=8, bbox_levels=4,
                        n_rand_pts=4096, vis_res_w=64, seed=0, device=device)
    oct_dev = octree_to_device(tree, capacity=32768, device=device)
    timings["octree"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    S = 384
    sample_l, _ = calibrate_sample_l(oct_dev, c2w, fx, fy, cx, cy, w, h, S,
                                     device)
    timings["calibrate"] = time.perf_counter() - t0
    scfg = SamplerConfig(max_samples=S, sample_l=sample_l)
    fcfg = FieldConfig(num_images=n_cams, n_volumes=tree.n_volumes,
                       num_levels=8, features_per_level=4,
                       hash_layout="packed", packed_rows_log2=15,
                       n_blocks=2, mlp_dtype="bfloat16")
    mcfg = GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=S)
    t0 = time.perf_counter()
    field = GFNeRFField(fcfg, *init_field_params(fcfg, seed=seed),
                        device=device)
    timings["field_init"] = time.perf_counter() - t0
    return {
        "cameras": (c2w, fx, fy, cx, cy, w, h), "tree": tree,
        "oct_dev": oct_dev, "scfg": scfg, "fcfg": fcfg, "mcfg": mcfg,
        "field": field, "timings": timings,
    }


def render_rays(render_fn, field, oct_dev, rays_o, rays_d, rel_camera_index,
                chunk: int):
    """Render (N, 3) rays chunk by chunk; returns {key: (N, k)} tensors."""
    outs = [render_fn(field, oct_dev, rays_o[i:i + chunk],
                      rays_d[i:i + chunk], rel_camera_index)
            for i in range(0, rays_o.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def render_camera(render_fn, field, oct_dev, cameras: Cameras,
                  camera_idx: int, chunk: int = CHUNK,
                  rel_camera_index: int | None = None):
    """Chunked full-image render of one camera (Pipeline.render_camera,
    pipeline.py:659-722).  Returns {key: (H, W, k)} tensors."""
    h = int(cameras.height[camera_idx])
    w = int(cameras.width[camera_idx])
    coords = torch.as_tensor(get_image_coords(h, w),
                             device=cameras.camera_to_worlds.device)
    rays = generate_rays(cameras, camera_idx, coords)
    out = render_rays(render_fn, field, oct_dev,
                      rays["origins"].reshape(-1, 3),
                      rays["directions"].reshape(-1, 3),
                      camera_idx if rel_camera_index is None
                      else rel_camera_index, chunk)
    return {k: v.reshape(h, w, -1) for k, v in out.items()}


def frame_rays(c2w: np.ndarray, width: int, height: int, device):
    """Rays of a virtual 60-degree camera at pose c2w (render_bench.py)."""
    focal = height / 2.0 / np.tan(np.deg2rad(60.0) / 2.0)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    d_cam = np.stack([(xx + 0.5 - width / 2) / focal,
                      -(yy + 0.5 - height / 2) / focal,
                      -np.ones_like(xx)], -1).reshape(-1, 3)
    d_w = d_cam @ c2w[:3, :3].T
    d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)
    o_w = np.broadcast_to(c2w[:3, 3], d_w.shape)
    return (torch.as_tensor(np.ascontiguousarray(o_w), dtype=torch.float32,
                            device=device),
            torch.as_tensor(d_w, dtype=torch.float32, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one frame and print its per-stage "
                         "device times as a JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("render_bench: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = build_workload(dev)
    render_fn = make_render_fn(wl["mcfg"], wl["scfg"])
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    cams = Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device=dev)
    t0 = time.perf_counter()
    for i in range(N_VIEWS):
        render_camera(render_fn, wl["field"], wl["oct_dev"], cams,
                      i * len(c2w) // N_VIEWS, args.chunk)
    torch.cuda.synchronize()
    t_views = time.perf_counter() - t0
    o, d = frame_rays(c2w[0], *FRAME_WH, dev)

    def frame():
        out = render_rays(render_fn, wl["field"], wl["oct_dev"], o, d, 0,
                          args.chunk)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    frame()
    print(f"[render_bench] warm-up frame {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        frame()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    if args.profile:
        prof = profile_device(frame)
        prof["device_busy_share"] = prof["device_busy_ms"] / (dt * 1e3)
        print(json.dumps({"profile": prof}))
    n = FRAME_WH[0] * FRAME_WH[1]
    print(json.dumps({
        "metric": "render_seconds_per_1080p_frame", "value": dt,
        "unit": "s/frame (median)", "frame_seconds": times,
        "rays_per_sec": n / dt, "chunk": args.chunk,
        "config": "quality", "views": N_VIEWS, "views_seconds": t_views,
        "device": torch.cuda.get_device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
