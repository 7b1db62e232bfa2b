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

``--stage focal`` renders the block stage's field, block-routed
(``render_chunk(..., stage_is_block=True)`` with a block per ray): the
training views concatenated into one mixed chunk, view i in block i mod
n_blocks, and the frames with an (R,) block vector of one block, each
after an init-stage frame of the same rays (``init_frame_seconds``), so that
the two are timed in turns.  The block tables, zero at init, are filled
with small random values from a seed.  ``device_allocs_in_timed_frames``
counts the allocator's ``cudaMalloc`` calls during the timed frames.

``--config`` picks one of ``bench.py``'s configs (``build_workload``);
``--stage focal`` needs one whose eval routes a block per ray (the packed
layout without the proposal probe: "quality" or "perf160").

``--early-term`` renders the timed frames through the two-phase
early-termination renderer (``models/render_early.py``; ``--et-s1``,
``--et-eps``) and adds the share of rays that survived phase 1 in the last
frame (``early_term``).  With random weights few rays saturate.

Run on a CUDA card:
  python -m gfnerf_tpu_torch.render_bench
      [--config {quality,perf160,prop,parity}] [--stage {init,focal}]
      [--early-term [--et-s1 N] [--et-eps EPS]] [--profile]
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
from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer
from gfnerf_tpu_torch.sampler.octree import build_octree
from gfnerf_tpu_torch.sampler.perssampler import (SamplerConfig,
                                                  octree_to_device)
from gfnerf_tpu_torch.utils.profiling import profile_device
from gfnerf_tpu_torch.utils.synthetic import ring_cameras

N_VIEWS = 4              # training views rendered before the frames
FRAME_WH = (1920, 1080)  # the timed frame's size
FRAMES = 5               # timed frames, after one warm-up frame
CHUNK = 32768            # rays per render chunk (scripts/render_bench.py)
CONFIGS = ("quality", "perf160", "prop", "parity")   # bench.py --config


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


def build_workload(device="cuda", seed: int = 0, config: str = "quality"):
    """The bench scene, octree and field of one of ``bench.py``'s configs:
    "quality" (profile_step.build_workload("quality"): packed layout, 8
    levels x 4 channels, 384 slots, ``sample_l`` calibrated, fineness 1),
    "perf160" (bench.py:389-391: the same field, 160 slots, ``sample_l``
    1/256, fineness 4), "prop" (bench.py:372-409: perf160's march and
    field with the proposal probe, no compaction, 64 fine samples a ray
    resampled from the probe's weights) or "parity" (bench.py:386-399:
    the anchored layout, 16 levels x 2 channels of 2^19 entries, 192
    slots, ``sample_l`` 1/256, fineness 4).

    Returns a dict: cameras (numpy c2w, fx, fy, cx, cy, w, h), tree,
    oct_dev, scfg, fcfg, mcfg, field, fineness (the train step's), config,
    and "timings" (seconds per set-up step)."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r} (have {CONFIGS})")
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
    common = dict(num_images=n_cams, n_volumes=tree.n_volumes, n_blocks=2,
                  mlp_dtype="bfloat16")
    prop = config == "prop"
    if config == "parity":
        S, sample_l, fineness = 192, 1.0 / 256, 4.0
        fcfg = FieldConfig(num_levels=16, features_per_level=2,
                           hash_layout="anchored", log2_hashmap_size=19,
                           **common)
    else:
        if config == "quality":
            S, fineness = 384, 1.0
            sample_l, _ = calibrate_sample_l(oct_dev, c2w, fx, fy, cx, cy, w,
                                             h, S, device)
        else:
            S, sample_l, fineness = 160, 1.0 / 256, 4.0
        fcfg = FieldConfig(num_levels=8, features_per_level=4,
                           hash_layout="packed", packed_rows_log2=15,
                           use_proposal=prop, **common)
    timings["calibrate"] = time.perf_counter() - t0
    scfg = SamplerConfig(max_samples=S, sample_l=sample_l)
    mcfg = GFNeRFModelConfig(scale_factor=1.0,
                             samples_budget_per_ray=0 if prop else S,
                             num_proposal_resamples=64 if prop else 0)
    t0 = time.perf_counter()
    field = GFNeRFField(fcfg, *init_field_params(fcfg, seed=seed),
                        device=device)
    timings["field_init"] = time.perf_counter() - t0
    return {
        "cameras": (c2w, fx, fy, cx, cy, w, h), "tree": tree,
        "oct_dev": oct_dev, "scfg": scfg, "fcfg": fcfg, "mcfg": mcfg,
        "field": field, "fineness": fineness, "config": config,
        "timings": timings,
    }


def render_rays(render_fn, field, oct_dev, rays_o, rays_d, rel_camera_index,
                chunk: int, blocks=None):
    """Render (N, 3) rays chunk by chunk; returns {key: (N, k)} tensors.
    ``rel_camera_index`` is one index or an (N,) tensor.  With ``blocks``
    the focal field renders: one block for all rays, or an (N,) tensor with
    a block per ray."""

    def part(x, i):
        return x[i:i + chunk] if isinstance(x, torch.Tensor) and x.dim() \
            else x

    outs = [render_fn(field, oct_dev, rays_o[i:i + chunk],
                      rays_d[i:i + chunk], part(rel_camera_index, i),
                      *(() if blocks is None else (part(blocks, i), True)))
            for i in range(0, rays_o.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def mixed_view_rays(cameras: Cameras, view_ids, n_blocks: int):
    """The rays of several training views as one batch, for one mixed
    render chunk: (origins (N, 3), directions (N, 3), camera index (N,),
    block (N,)), view number i of ``view_ids`` in block i mod n_blocks."""
    o, d, cam, blk = [], [], [], []
    dev = cameras.camera_to_worlds.device
    for i, view in enumerate(view_ids):
        coords = torch.as_tensor(
            get_image_coords(int(cameras.height[view]),
                             int(cameras.width[view])), device=dev)
        rays = generate_rays(cameras, view, coords)
        o.append(rays["origins"].reshape(-1, 3))
        d.append(rays["directions"].reshape(-1, 3))
        cam.append(torch.full((o[-1].shape[0],), view, dtype=torch.int64,
                              device=dev))
        blk.append(torch.full((o[-1].shape[0],), i % n_blocks,
                              dtype=torch.int32, device=dev))
    return torch.cat(o), torch.cat(d), torch.cat(cam), torch.cat(blk)


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


def randomize_block_tables(field: GFNeRFField) -> None:
    """Fill the block tables, zero at init in residual mode, with
    uniform(-1e-2, 1e-2) values (the global table's init range) from a
    fixed seed, so that the blocks of a benched focal render differ as
    trained ones do."""
    dev = field.block_feats.device
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        field.block_feats.copy_((torch.rand(
            field.block_feats.shape, generator=gen, device=dev) - 0.5) * 2e-2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="quality", choices=CONFIGS)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--stage", default="init", choices=["init", "focal"],
                    help="focal: the block stage's field, routed: the views "
                         "as one mixed chunk, view i in block i mod "
                         "n_blocks, and the frame with a block per ray")
    ap.add_argument("--early-term", action="store_true",
                    help="the frames through the two-phase early-termination "
                         "renderer (models/render_early.py): saturated rays "
                         "skip their tail samples")
    ap.add_argument("--et-s1", type=int, default=0,
                    help="head-segment samples (0: max(32, S // 4))")
    ap.add_argument("--et-eps", type=float, default=5e-3,
                    help="termination transmittance threshold")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one frame and print its per-stage "
                         "device times as a JSON line")
    args = ap.parse_args(argv)
    if args.stage == "focal" and args.config in ("prop", "parity"):
        ap.error(f"--stage focal routes a block per ray, which --config "
                 f"{args.config} does not render")
    if not torch.cuda.is_available():
        print("render_bench: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = build_workload(dev, config=args.config)
    field, oct_dev = wl["field"], wl["oct_dev"]
    focal = args.stage == "focal"
    render_fn = make_render_fn(wl["mcfg"], wl["scfg"])
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    cams = Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device=dev)
    view_ids = [i * len(c2w) // N_VIEWS for i in range(N_VIEWS)]
    o, d = frame_rays(c2w[0], *FRAME_WH, dev)
    frame_blocks = None
    if focal:
        randomize_block_tables(field)
        frame_blocks = torch.zeros(o.shape[0], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    if focal:   # all views in one chunk, each in its own block
        vo, vd, vcam, vblk = mixed_view_rays(cams, view_ids,
                                             wl["fcfg"].n_blocks)
        render_rays(render_fn, field, oct_dev, vo, vd, vcam, args.chunk, vblk)
    else:
        for view in view_ids:
            render_camera(render_fn, field, oct_dev, cams, view, args.chunk)
    torch.cuda.synchronize()
    t_views = time.perf_counter() - t0

    et, survived = None, []
    if args.early_term:
        et = EarlyTermRenderer(wl["mcfg"], wl["scfg"], s1=args.et_s1 or None,
                               eps=args.et_eps)

    def et_chunk(*chunk_args):
        out = et.render_chunk(*chunk_args)
        survived.append((et.last_survivor_frac, chunk_args[2].shape[0]))
        return out

    def frame(blocks=frame_blocks):
        if et is not None and blocks is frame_blocks:
            survived.clear()
            out = render_rays(et_chunk, field, oct_dev, o, d, 0, args.chunk,
                              blocks)
        else:
            out = render_rays(render_fn, field, oct_dev, o, d, 0, args.chunk,
                              blocks)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    frame()
    if focal:
        frame(None)
    print(f"[render_bench] warm-up {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)
    # focal: each routed frame follows an init-stage frame of the same rays,
    # so that the two are compared in turns inside one run
    times, init_times = [], []
    allocs0 = torch.cuda.memory_stats()["num_device_alloc"]
    for _ in range(FRAMES):
        if focal:
            t0 = time.perf_counter()
            frame(None)
            init_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        frame()
        times.append(time.perf_counter() - t0)
    allocs = torch.cuda.memory_stats()["num_device_alloc"] - allocs0
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
        "config": args.config, "stage": args.stage, "views": N_VIEWS,
        "views_seconds": t_views,
        **({"init_frame_seconds": init_times} if focal else {}),
        "device_allocs_in_timed_frames": allocs,
        **({"early_term": {"s1": et.s1, "eps": et.eps, "survivor_frac": sum(
            f * n for f, n in survived) / sum(n for _, n in survived)}}
           if et is not None else {}),
        "device": torch.cuda.get_device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
