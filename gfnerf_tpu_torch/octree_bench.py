"""Octree-construction timing of the PyTorch port.

Times ``build_octree`` on the training pipeline's synthetic scene (48 ring
cameras at 96x72, ``make_synthetic_npz``; the pipeline's camera bounds) at
``gf-nerf-perf``'s own sampler settings (``max_level 16, bbox_levels 10,
n_rand_pts 32768, vis_res_w 128``) and at the bench's (``BENCH_TREE``, as
``render_bench`` builds its tree), which ``chip_smoke.py``'s pipeline phase
uses.  Each build's time is split between the visibility test (torch, on
the device) and the rest, most of which is the per-leaf warp construction
(``construct_trans``, numpy on a thread pool of the host).  Prints one JSON
line per setting:

  {"settings": "config", "max_level": 16, ..., "s": <build s>,
   "visibility_s": ..., "leaves": ..., "volumes": ..., "nodes": ...}

Run on a CUDA card:
  python -m gfnerf_tpu_torch.octree_bench [--settings {config,bench}]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gfnerf_tpu_torch.sampler import octree as octree_mod

# the bench's tree (render_bench.build_workload), in the sampler's names
BENCH_TREE = {"max_level": 8, "bbox_levels": 4, "n_rand_pts": 4096,
              "vis_res_w": 64}


def scene_cameras(tmp: Path):
    """(c2w, intri, bounds) of the pipeline's 48-view synthetic scene."""
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.pipeline import GFNerfPipelineConfig
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = make_synthetic_npz(tmp, n_train=48, n_val=4, img_wh=(96, 72))
    cams = build_dataparser("minimal", scene).get_dataparser_outputs(
        "train").cameras
    bounds = np.tile(np.asarray(GFNerfPipelineConfig().camera_bounds,
                                np.float32), (len(cams), 1))
    return cams.camera_to_worlds, cams.intrinsics_matrices(), bounds


def time_build(c2w, intri, bounds, settings: dict, device) -> dict:
    """One ``build_octree`` at the sampler ``settings``, timed; the time in
    the visibility test counted apart."""
    from gfnerf_tpu_torch.configs.method_configs import get_method

    scfg = get_method("gf-nerf-perf").pipeline.sampler
    kw = {k: settings.get(k, getattr(scfg, k)) for k in
          ("max_level", "bbox_levels", "n_rand_pts", "vis_res_w")}
    make_visibility = octree_mod._make_visibility_fn
    spent = [0.0]

    def timed_make_visibility(*args):
        visi = make_visibility(*args)

        def timed_visi(*a):
            t = time.perf_counter()
            out = visi(*a)   # ends in a copy to the host
            spent[0] += time.perf_counter() - t
            return out

        return timed_visi

    octree_mod._make_visibility_fn = timed_make_visibility
    try:
        t0 = time.perf_counter()
        tree = octree_mod.build_octree(
            c2w, intri, bounds, max_depth=kw["max_level"],
            bbox_levels=kw["bbox_levels"],
            split_dist_thres=scfg.split_dist_thres, seed=scfg.seed,
            n_rand_pts=kw["n_rand_pts"], vis_res_w=kw["vis_res_w"],
            device=device)
        total = time.perf_counter() - t0
    finally:
        octree_mod._make_visibility_fn = make_visibility
    return {**kw, "s": total, "visibility_s": spent[0],
            "leaves": int(tree.is_leaf.sum()),
            "volumes": int((tree.trans_idx >= 0).sum()),
            "nodes": tree.n_nodes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settings", choices=("config", "bench"),
                    action="append",
                    help="which settings to time (default: both)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="octree_bench_") as tmp:
        c2w, intri, bounds = scene_cameras(Path(tmp))
    for name in args.settings or ("bench", "config"):
        row = time_build(c2w, intri, bounds,
                         BENCH_TREE if name == "bench" else {}, device)
        print(json.dumps({"settings": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
