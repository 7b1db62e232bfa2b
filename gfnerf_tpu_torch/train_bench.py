"""Training-throughput benchmark of the PyTorch port (one train step).

The port's counterpart of ``bench.py --config {quality,perf160,prop,parity}
--stage {init,focal}``: the scene, octree and field of
``render_bench.build_workload`` (48 ring cameras at 96x72 around the
synthetic sphere scene, depth-8 octree, bf16 MLPs; "quality": 8 levels x 4
channels of 2^15 packed rows, 384 march slots, fineness 1, ``sample_l``
calibrated; "perf160": the same field, 160 slots, ``sample_l`` 1/256,
fineness 4; "prop": perf160 with the proposal probe, 64 fine samples a
ray; "parity": the anchored layout, 16 levels x 2 channels of 2^19
entries, 192 slots, ``sample_l`` 1/256, fineness 4), the training images
rendered by ``render_spheres``, ``OptimizersConfig()`` defaults, and batches
of 8192 rays drawn as ``bench.py`` draws them.  ``--stage focal`` times the
block stage's step on block 0 from a fresh optimizer state, as ``bench.py``
does.  The batches are staged on the card before the timer.

``--steps-per-dispatch K`` (default 8, ``bench.py:415``'s window) trains
K steps a dispatch through ``make_multi_train_step``: one CUDA graph of
the step replayed K times, each window's stacked batches staged on the
device; one warm-up window (it captures the graph), then 10 timed
windows, each ending in a device synchronize (where the pipeline reads
its one copy back): s/step is their total over 10 K steps.  ``1`` keeps
the loop of single steps, each ending in a synchronize: one warm-up
step, then 10 timed.  Prints one JSON line:

  {"metric": "train_rays_per_sec_per_chip", "value": <rays / mean step s>,
   "unit": "rays/s", "step_seconds": [...], "rays": 8192,
   "steps_per_dispatch": 8, "config": "quality", "stage": "init",
   "device": ...}

(``step_seconds``: per step, or per window divided by K.)  ``--profile``
also runs one step (one window at K > 1) under the profiler and prints
its per-stage device spans (rays, march, warp, proposal, encode, base
MLP, colour head, composite, loss, backward, optimizer, occupancy; a
replayed window records only the first step's spans), the device's busy
time and idle share, and the busiest kernels.

Run on a CUDA card:
  python -m gfnerf_tpu_torch.train_bench
      [--config {quality,perf160,prop,parity}] [--stage {init,focal}]
      [--steps-per-dispatch K] [--profile]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.cameras import Cameras
from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                build_optimizer)
from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
from gfnerf_tpu_torch.models.gfnerf import (init_train_state,
                                            make_multi_train_step,
                                            make_train_step)
from gfnerf_tpu_torch.render_bench import CONFIGS, build_workload
from gfnerf_tpu_torch.utils.profiling import profile_device
from gfnerf_tpu_torch.utils.synthetic import render_spheres

RAYS = 8192   # rays per step (bench.py)
STEPS = 10    # timed steps (or windows), after one warm-up
K = 8         # steps a dispatch (bench.py:415)


def build_train_workload(device="cuda", seed: int = 0,
                         config: str = "quality") -> dict:
    """``render_bench.build_workload`` plus what training needs: "images"
    (N, H, W, 3) numpy, "cams" (Cameras on the device), "tx" (the
    per-group Adam), "state" (TrainState), "step_fn" (the init stage's
    step) and "focal_step_fn" (the block stage's)."""
    wl = build_workload(device, seed, config)
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    wl["images"] = render_spheres(c2w, fx, fy, cx, cy, w, h)
    wl["cams"] = Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device=device)
    wl["tx"] = build_optimizer(OptimizersConfig())
    wl["state"] = init_train_state(wl["field"], wl["tx"])
    wl["step_fn"] = make_train_step(wl["mcfg"], wl["scfg"], wl["tx"],
                                    STAGE_INIT)
    wl["focal_step_fn"] = make_train_step(wl["mcfg"], wl["scfg"], wl["tx"],
                                          STAGE_BLOCK)
    return wl


def make_batch(images: np.ndarray, rays: int, seed: int, device) -> dict:
    """Random pixels of random training views (bench.py make_batches)."""
    n_cams, h, w, _ = images.shape
    rng = np.random.default_rng(seed)
    ki = rng.integers(0, n_cams, rays)
    yi = rng.integers(0, h, rays)
    xi = rng.integers(0, w, rays)
    cam = torch.as_tensor(ki, dtype=torch.int64, device=device)
    return {
        "camera_indices": cam, "rel_camera_indices": cam,
        "coords": torch.as_tensor(np.stack([yi + 0.5, xi + 0.5], -1),
                                  dtype=torch.float32, device=device),
        "image": torch.as_tensor(images[ki, yi, xi], dtype=torch.float32,
                                 device=device),
    }


def run_steps(wl: dict, batches, generator, focal_block=None):
    """One train step per batch at the workload's fineness, each ending in
    a synchronize: init-stage steps, or with ``focal_block`` block-stage
    steps on that block.  Returns (seconds per step, loss per step);
    updates wl["state"] and wl["oct_dev"]."""
    times, losses = [], []
    step_fn = wl["step_fn" if focal_block is None else "focal_step_fn"]
    for batch in batches:
        t0 = time.perf_counter()
        wl["state"], wl["oct_dev"], metrics, _ = step_fn(
            wl["state"], wl["oct_dev"], wl["cams"], batch, wl["fineness"],
            generator=generator, active_block=focal_block or 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    return times, losses


def stack_window(batches) -> dict:
    """K batches of ``make_batch`` as one window's (K, R, ...) stacks."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def run_windows(wl: dict, windows, generator, k: int, focal_block=None,
                draws=None, graph=True):
    """One window of k steps per stacked batch (``stack_window``) at the
    workload's fineness, through ``make_multi_train_step`` (kept in
    wl["window_fns"]), each ending in a synchronize: init-stage windows,
    or with ``focal_block`` block-stage windows on that block.  ``draws``
    (one per window, or None: the generator's) and ``graph`` go to the
    window function; another stage's kept graph is dropped.  Returns
    (seconds per window, (k,) losses per
    window); updates wl["state"] and wl["oct_dev"]."""
    stage = STAGE_INIT if focal_block is None else STAGE_BLOCK
    fns = wl.setdefault("window_fns", {})
    fn = fns.get((stage, k))
    if fn is None:
        fn = fns[(stage, k)] = make_multi_train_step(
            wl["mcfg"], wl["scfg"], wl["tx"], stage, k)
    for key, other in fns.items():
        if key != (stage, k):   # one kept graph, as in the pipeline
            other.reset()
    fine = torch.full((k,), float(wl["fineness"]), dtype=torch.float32,
                      device=wl["state"].field.global_feat.device)
    times, losses = [], []
    for i, batches in enumerate(windows):
        t0 = time.perf_counter()
        wl["state"], wl["oct_dev"], metrics, _ = fn(
            wl["state"], wl["oct_dev"], wl["cams"], batches, fine,
            active_block=focal_block or 0, generator=generator,
            draws=None if draws is None else draws[i], graph=graph)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].tolist())
    return times, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="quality", choices=CONFIGS)
    ap.add_argument("--stage", default="init", choices=["init", "focal"],
                    help="focal: the block stage's step on block 0 "
                         "(residual table, frozen shared parameters)")
    ap.add_argument("--steps-per-dispatch", type=int, default=K,
                    help="steps a dispatch: K > 1 replays the step as a "
                         "CUDA graph K times a window; 1 runs single steps")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one step (one window at K > 1) and "
                         "print its per-stage device spans as a JSON line")
    args = ap.parse_args(argv)
    k = args.steps_per_dispatch
    if k < 1:
        ap.error("--steps-per-dispatch must be at least 1")
    if not torch.cuda.is_available():
        print("train_bench: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = build_train_workload(dev, config=args.config)
    block = 0 if args.stage == "focal" else None   # bench.py:451
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [make_batch(wl["images"], RAYS, seed, dev)
               for seed in range((STEPS + 2) * k)]
    if k > 1:
        batches = [stack_window(batches[i:i + k])
                   for i in range(0, len(batches), k)]

    def run(part):
        if k == 1:
            return run_steps(wl, part, gen, block)
        return run_windows(wl, part, gen, k, block)

    torch.cuda.synchronize()   # staged before the timer (bench.py:459-473)
    warm, _ = run(batches[:1])
    print(f"[train_bench] warm-up {'step' if k == 1 else 'window'} "
          f"{warm[0]:.2f}s", file=sys.stderr)
    torch.cuda.reset_peak_memory_stats()
    times, losses = run(batches[1:STEPS + 1])
    times = [t / k for t in times]
    dt = float(np.mean(times))
    if args.profile:
        prof = profile_device(lambda: run(batches[-1:]))
        prof["device_busy_share"] = prof["device_busy_ms"] / (dt * k * 1e3)
        prof["device_idle_share"] = 1.0 - prof["device_busy_share"]
        print(json.dumps({"profile": prof}))
    print(json.dumps({
        "metric": "train_rays_per_sec_per_chip", "value": RAYS / dt,
        "unit": "rays/s", "step_seconds": times, "rays": RAYS,
        "steps_per_dispatch": k, "config": args.config, "stage": args.stage,
        "device": torch.cuda.get_device_name(dev),
        "losses": losses, "peak_bytes": torch.cuda.max_memory_allocated(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
