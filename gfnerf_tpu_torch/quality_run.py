"""Quality run: train gf-nerf through both stages on the textured scene
and record eval PSNR / SSIM / the LPIPS proxy at the transition and after
the splits, beside the trivial predictors.

The port's counterpart of ``scripts/quality_run.py``, with its flags,
defaults, config and output keys:

  python -m gfnerf_tpu_torch.quality_run [--config {perf,parity,prop}]
      [--diag] [--scene-variant {textured,smooth}] [--init-steps N]
      [--split-steps N] [--n-blocks B] [--init-ckpt DIR] [--out FILE]
      [--device {cuda,cpu}] [--output-dir DIR] [...]

The scene is a checkered ground plane and textured spheres
(``utils/synthetic.render_textured_scene``) seen by two rings of cameras
at 160x120 (72 train, 6 val), written as the minimal parser's npz files.
The model is judged against the mean-image and black-image predictors
(``trivial_baselines``) after the init stage (``after_init``) and at the
end (``final``); with ``--diag`` also after each split but the last
(``after_split{b}``), each of those with ``diag_eval``'s renders of every
val camera routed, through the shared (init-stage) field alone, and
forced through each block (``<milestone>_diag``).  Results go to
``--out`` (default ``outputs/quality_results.json``) after every
milestone.  ``perf`` is the packed layout (8 levels x 4 of 2^15 rows,
bf16 MLPs, 4096 rays, a budget of 384 samples, 1600 + B x 700 steps),
``parity`` the anchored one (16 x 2 of 2^19, 2048 rays, 512, 800 + B x
350), ``prop`` ``perf`` with proposal resampling (64 fine samples).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np


def build_scene(tmp: Path, n_train=72, n_val=6, img_wh=(160, 120),
                variant="textured"):
    """Write the textured scene's train.npz and val.npz into ``tmp``
    (cameras on two rings, a seeded split); returns the val images."""
    from gfnerf_tpu_torch.utils.synthetic import (render_textured_scene,
                                                  ring_cameras)

    total = n_train + n_val
    # two rings at different radii/heights for parallax
    c2w1, fx1, fy1, cx1, cy1, w, h = ring_cameras(
        total // 2, radius=4.0, height=1.2, img_wh=img_wh, focal=110.0)
    c2w2, fx2, fy2, cx2, cy2, _, _ = ring_cameras(
        total - total // 2, radius=5.5, height=2.4, img_wh=img_wh,
        focal=110.0)
    c2w = np.concatenate([c2w1, c2w2])
    fx = np.concatenate([fx1, fx2])
    fy = np.concatenate([fy1, fy2])
    cx = np.concatenate([cx1, cx2])
    cy = np.concatenate([cy1, cy2])
    imgs = render_textured_scene(
        c2w, fx, fy, cx, cy, w, h, smooth=(variant == "smooth"),
        supersample=2 if variant == "smooth" else 1)
    rng = np.random.default_rng(0)
    perm = rng.permutation(total)
    tr, va = perm[:n_train], perm[n_train:]
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    for split, idx in (("train", tr), ("val", va)):
        np.savez(tmp / f"{split}.npz",
                 images=imgs[idx], c2w=c2w[idx],
                 fx=fx[idx], fy=fy[idx], cx=cx[idx], cy=cy[idx],
                 width=np.full(len(idx), w), height=np.full(len(idx), h))
    return imgs[va]


def trivial_baselines(val_imgs):
    """Mean PSNR over ``val_imgs`` of the black image and of the images'
    mean colour."""
    out = {}
    for name, pred in (("black", np.zeros_like(val_imgs[0])),
                       ("mean", val_imgs.mean(axis=(0, 1, 2),
                                              keepdims=True)[0])):
        mses = [(np.mean((img - pred) ** 2)) for img in val_imgs]
        out[f"{name}_psnr"] = float(np.mean(
            [-10 * np.log10(m + 1e-12) for m in mses]))
    return out


def diag_eval(pipe, step, n_blocks):
    """Every val camera rendered four ways: "routed", the standard eval
    with the block nearest the camera; "shared_only", the residuals off
    (after the transition this reproduces ``after_init`` if the focal
    stage leaves the shared parameters frozen); "block{b}", forced through
    block b's residual.  Mean PSNR and SSIM and each camera's PSNR for
    each, and the block routing picks for each camera."""
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.pipelines.pipeline import compute_ssim

    dm = pipe.datamanager
    cams = dm.eval_dataparser_outputs.cameras
    variants = {"routed": {}, "shared_only": {"stage": STAGE_INIT}}
    for b in range(n_blocks):
        variants[f"block{b}"] = {"stage": STAGE_BLOCK, "force_split_idx": b}
    out = {}
    for name, kw in variants.items():
        psnrs, ssims = [], []
        for i in range(len(dm.eval_dataset)):
            cam_idx, data = dm.next_eval_image(i)
            r = pipe.render_camera(cams, pipe.eval_cameras_dev, cam_idx,
                                   step, **kw)
            mse = float(np.mean((r["rgb"] - data["image"]) ** 2))
            psnrs.append(-10.0 * np.log10(mse + 1e-12))
            ssims.append(float(compute_ssim(r["rgb"], data["image"])))
        out[name] = {"psnr": float(np.mean(psnrs)),
                     "ssim": float(np.mean(ssims)),
                     "per_cam_psnr": [round(p, 2) for p in psnrs]}
    # which block does routing pick per val camera?
    out["routing"] = [
        int(pipe.sampler.get_nearest_split_dataset(
            np.asarray(cams.camera_to_worlds[i][:, 3]))[0])
        for i in range(len(dm.eval_dataset))]
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="perf",
                    choices=["parity", "perf", "prop"])
    ap.add_argument("--diag", action="store_true",
                    help="extra per-block/shared-only evals at each "
                         "milestone + eval after every split")
    ap.add_argument("--out", type=Path,
                    default=Path("outputs/quality_results.json"))
    ap.add_argument("--scene-dir", type=Path, default=None,
                    help="default: outputs/quality_scene[_<variant>]")
    ap.add_argument("--scene-variant", default="textured",
                    choices=["textured", "smooth"],
                    help="smooth: band-limited photo-consistent GT "
                         "(sin quasi-checker, distance-faded texture, 2x "
                         "supersampled render)")
    ap.add_argument("--init-steps", type=int, default=None)
    ap.add_argument("--split-steps", type=int, default=None)
    ap.add_argument("--block-wd", type=float, default=None,
                    help="residual-table weight decay")
    ap.add_argument("--block-lr", type=float, default=None)
    ap.add_argument("--block-rows-log2", type=int, default=None,
                    help="residual-table rows (log2) when != global")
    ap.add_argument("--rows-log2", type=int, default=None,
                    help="hash rows per level (global AND residual tables)")
    ap.add_argument("--uniform-sampling", action="store_true",
                    help="disable error-map-weighted focal sampling")
    ap.add_argument("--mix-fraction", type=float, default=None,
                    help="fraction of each focal batch drawn uniformly "
                         "from the full scene")
    ap.add_argument("--empty-penalty", type=float, default=None,
                    help="multiplier on the focal empty-space penalty")
    ap.add_argument("--empty-tau", type=float, default=None,
                    help="shared-branch alpha threshold for 'empty' "
                         "(default 0.01)")
    ap.add_argument("--dense-levels", type=int, default=None,
                    help="first k residual levels use collision-free "
                         "linear addressing where the grid fits the table")
    ap.add_argument("--remat-chunks", type=int, default=None,
                    help="recompute the field in this many chunks in the "
                         "backward")
    ap.add_argument("--hash-layout", default=None,
                    choices=["packed", "anchored"],
                    help="override the config's hash layout at otherwise "
                         "identical settings")
    ap.add_argument("--focal-mode", default=None,
                    choices=["residual", "finetune"],
                    help="finetune: per-block fine-tuned copies of the "
                         "trained global table instead of additive "
                         "residuals")
    ap.add_argument("--trust-mult", type=float, default=None,
                    help="L2 trust-region pull of the fine-tuned table "
                         "toward the global anchor (finetune mode)")
    ap.add_argument("--n-blocks", type=int, default=2,
                    help="focal blocks / dataset splits (reference default "
                         "10; the quality runs keep 2)")
    ap.add_argument("--n-train", type=int, default=None,
                    help="number of training cameras (default 72)")
    ap.add_argument("--n-val", type=int, default=None)
    ap.add_argument("--img-wh", default=None,
                    help="scene image size WxH (default 160x120)")
    ap.add_argument("--rays-per-batch", type=int, default=None)
    ap.add_argument("--max-depth", type=int, default=None,
                    help="octree max depth")
    ap.add_argument("--init-ckpt", type=Path, default=None,
                    help="checkpoint dir saved at the init->focal "
                         "transition: written there after init if absent, "
                         "loaded (skipping init) if present")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--output-dir", type=Path,
                    default=Path("outputs/quality_out"),
                    help="the run's directory is OUTPUT_DIR/<config>/...")
    return ap.parse_args(argv)


def quality_config(args, scene: Path):
    """The TrainerConfig ``scripts/quality_run.py``'s main builds for
    ``args`` on ``scene`` (the run's directory under ``args.output_dir``,
    the device ``args.device``)."""
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_config

    cfg = gf_nerf_config()
    p = cfg.pipeline
    # a budget below the marched count truncates far content once the
    # march fineness anneals to 1, so the quality runs size the budget to
    # the scene (the reference evaluates every valid sample)
    if args.config in ("perf", "prop"):
        init_steps = args.init_steps or 1600
        split_steps = args.split_steps or 700
        p.field_num_levels = 8
        p.field_features_per_level = 4
        p.field_hash_layout = "packed"
        p.field_packed_rows_log2 = 15
        p.field_mlp_dtype = "bfloat16"
        p.model.samples_budget_per_ray = 384
        p.sampler.max_samples = 384
        if args.config == "prop":
            # proposal-guided resampling: the march feeds the probe, the
            # main field runs on the fine samples only
            p.field_use_proposal = True
            p.model.num_proposal_resamples = 64
            p.model.samples_budget_per_ray = 0   # proposal replaces compaction
    else:
        init_steps = args.init_steps or 800
        split_steps = args.split_steps or 350
        p.field_log2_hashmap_size = 19
        p.model.samples_budget_per_ray = 512
        p.sampler.max_samples = 512
        p.datamanager.train_num_rays_per_batch = 2048
    n_blocks = args.n_blocks
    p.model.n_blocks = n_blocks
    p.model.n_split_dataset = n_blocks
    p.model.steps_perssampler_init = init_steps
    p.model.steps_per_split_dataset = split_steps
    p.model.scale_factor = 1.0
    p.datamanager.n_split_dataset = n_blocks
    p.datamanager.steps_per_split_dataset = split_steps
    p.datamanager.steps_perssampler_init = init_steps
    if args.config == "perf":
        p.datamanager.train_num_rays_per_batch = 4096
    p.optimizers.steps_perssampler_init = init_steps
    p.optimizers.steps_per_split_dataset = split_steps
    p.optimizers.n_split_dataset = n_blocks
    if args.rows_log2 is not None:
        p.field_packed_rows_log2 = args.rows_log2
    if args.block_rows_log2 is not None:
        p.field_block_rows_log2 = args.block_rows_log2
    if args.block_wd is not None:
        p.optimizers.block_weight_decay = args.block_wd
    if args.block_lr is not None:
        p.optimizers.block_lr_init = args.block_lr
    if args.uniform_sampling:
        p.use_error_sampling = False
    if args.mix_fraction is not None:
        p.datamanager.focal_uniform_fraction = args.mix_fraction
    if args.empty_penalty is not None:
        p.model.empty_space_penalty_mult = args.empty_penalty
    if args.empty_tau is not None:
        p.model.empty_space_tau = args.empty_tau
    if args.dense_levels is not None:
        p.field_block_dense_levels = args.dense_levels
    if args.remat_chunks is not None:
        p.model.remat_chunks = args.remat_chunks
    if args.hash_layout is not None:
        p.field_hash_layout = args.hash_layout
    if args.focal_mode is not None:
        p.field_focal_mode = args.focal_mode
    if args.trust_mult is not None:
        p.model.finetune_trust_mult = args.trust_mult
    if args.rays_per_batch is not None:
        p.datamanager.train_num_rays_per_batch = args.rays_per_batch
    if args.max_depth is not None:
        p.sampler.max_level = args.max_depth
    p.sampler.sub_div_milestones = (init_steps // 8, init_steps // 4,
                                    init_steps // 2)
    p.sampler.ray_march_fineness_decay_end_iter = init_steps
    p.camera_bounds = (0.01, 50.0)
    cfg.max_num_iterations = init_steps + n_blocks * split_steps
    cfg.steps_per_eval_batch = 10 ** 9
    cfg.steps_per_eval_image = 10 ** 9
    cfg.steps_per_save = 10 ** 9
    cfg.vis = "local"
    cfg.data = Path(scene)
    cfg.output_dir = Path(args.output_dir) / args.config
    cfg.experiment_name = f"quality-{args.config}"
    cfg.device = args.device
    return cfg


def scene_dir(args) -> Path:
    """``--scene-dir``, or the default directory of the scene ``args``
    describe (written there by ``run`` when absent)."""
    if args.scene_dir is not None:
        return args.scene_dir
    suffix = "" if args.scene_variant == "textured" else (
        "_" + args.scene_variant)
    if args.n_train or args.img_wh:
        w, h = scene_wh(args)
        suffix += f"_{args.n_train or 72}c_{w}x{h}"
    return Path("outputs/quality_scene" + suffix)


def scene_wh(args) -> tuple:
    return (tuple(int(v) for v in args.img_wh.split("x"))
            if args.img_wh else (160, 120))


def run(args, log=print) -> dict:
    """Build the scene where it is missing, train, evaluate at the
    milestones and write ``args.out``; returns the results."""
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.engine.trainer import Trainer

    scene = scene_dir(args)
    if not (scene / "train.npz").exists():
        log("building scene ...")
        build_scene(scene, n_train=args.n_train or 72,
                    n_val=args.n_val or 6, img_wh=scene_wh(args),
                    variant=args.scene_variant)
    val_imgs = np.load(scene / "val.npz")["images"]
    base = trivial_baselines(val_imgs)
    log(f"trivial baselines: {base}")

    cfg = quality_config(args, scene)
    init_steps = cfg.pipeline.model.steps_perssampler_init
    split_steps = cfg.pipeline.model.steps_per_split_dataset
    n_blocks = args.n_blocks
    trainer = Trainer(cfg, MinimalDataParser(
        MinimalDataParserConfig(data=scene)))
    trainer.setup()
    pipe = trainer.pipeline
    sync = _device_sync(cfg.device)

    results = {"config": args.config, "baselines": base,
               "init_steps": init_steps, "split_steps": split_steps}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    milestones = {init_steps: "after_init",
                  cfg.max_num_iterations: "final"}
    if args.diag:
        for b in range(1, n_blocks):
            milestones[init_steps + b * split_steps] = f"after_split{b - 1}"
    step = 0
    ic = args.init_ckpt
    if ic is not None and (ic / "meta.json").exists():
        loaded = pipe.load_checkpoint_state(ic)
        if loaded != init_steps:
            raise ValueError(f"{ic} holds step {loaded}, not the "
                             f"transition's {init_steps}")
        step = loaded
        em = json.loads((ic / "after_init_eval.json").read_text())
        results["after_init"] = em
        log(f"resumed at init->focal transition from {ic}")
    train_s, trained = 0.0, 0
    while step < cfg.max_num_iterations:
        sync()
        ts = time.perf_counter()
        m = pipe.get_train_loss_dict(step)
        pipe.after_train_iteration(step)
        sync()
        train_s += time.perf_counter() - ts
        trained += 1
        step += 1
        if step % 200 == 0:
            log(f"step {step}: loss {m.get('loss', float('nan')):.4f} "
                f"({(time.time() - t0) / 60:.1f} min)")
        if step in milestones:
            em = pipe.get_average_eval_image_metrics(step)
            results[milestones[step]] = em
            log(f"== {milestones[step]} eval @{step}: {em}")
            if args.diag and step > init_steps:
                d = diag_eval(pipe, step, n_blocks)
                results[milestones[step] + "_diag"] = d
                log(f"== diag @{step}: {json.dumps(d)}")
            if (ic is not None and step == init_steps
                    and not (ic / "meta.json").exists()):
                ic.mkdir(parents=True, exist_ok=True)
                pipe.save_checkpoint_state(ic, step)
                (ic / "after_init_eval.json").write_text(json.dumps(em))
                log(f"saved init->focal checkpoint to {ic}")
            args.out.write_text(json.dumps(results, indent=2))
    results["minutes"] = (time.time() - t0) / 60
    # the train steps alone (the card synchronised around each)
    results["s_per_step"] = train_s / max(trained, 1)
    if args.diag:  # keep the end state inspectable post-hoc
        ckpt = args.out.parent / (args.out.stem + "_ckpt")
        if ckpt.exists():
            shutil.rmtree(ckpt)
        ckpt.mkdir(parents=True)
        pipe.save_checkpoint_state(ckpt, step)
        results["checkpoint"] = str(ckpt)
    args.out.write_text(json.dumps(results, indent=2))
    return results


def _device_sync(device: str):
    if device != "cuda":
        return lambda: None
    import torch

    return torch.cuda.synchronize


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("quality_run: no CUDA card (pass --device cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 1
    results = run(args, log=lambda msg: print(msg, flush=True))
    print(json.dumps(results, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
