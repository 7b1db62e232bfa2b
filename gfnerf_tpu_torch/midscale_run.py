"""Mid-scale run through the command line: train, kill, resume, eval.

The port's counterpart of ``scripts/midscale_run.py``: ``python -m
gfnerf_tpu_torch.train gf-nerf`` on a textured scene written in the
nerfstudio layout (96 cameras on three rings at 200x150), at a size
where the init stage makes three milestone octree rebuilds and the focal
stage trains 4 blocks.  Phase 1 trains in a session of its own and is
sent SIGTERM (the whole process group) once its log passes ``kill_at``,
in the middle of block 1; phase 2 resumes with ``--load-dir`` to the end;
``python -m gfnerf_tpu_torch.eval`` reads the run's ``config.json``.

  python -m gfnerf_tpu_torch.midscale_run [--fast] [--out-dir DIR]
      [--scene-dir DIR] [--run-dir DIR] [--init-steps N]
      [--split-steps N] [--n-cams N] [--img-wh WxH] [--device {cuda,cpu}]
      [a.b.c=value ...]

``--out-dir`` (default ``outputs/midscale``) gets both phases' logs, the
eval's JSON and ``summary.json``: the milestone rebuilds and hit-budget
calibrations each phase logged, the step phase 1 was killed at, the
checkpoint phase 2 resumed from and the step it resumed at, the exit
codes, the eval, the val images' black- and mean-image PSNR, each
phase's minutes and seconds to its first logged step, and its median
seconds a step (the trainer's logged ``Train Iter (time)``).  ``--fast`` shrinks the steps to 200 + 4 x 80 and the batch
to 1024 rays of 192 samples.  Trailing ``a.b.c=value`` arguments are
passed on to ``train`` after the script's own overrides (a rehearsal on
the CPU shrinks the batch and saves and logs more often).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
N_BLOCKS = 4
EXPERIMENT = "midscale"
POLL_S = 0.5   # seconds between reads of a phase's log


def build_nerfstudio_scene(out: Path, n_cams=96, img_wh=(200, 150)) -> int:
    """The textured scene in the nerfstudio layout (``images/`` of PNGs
    and ``transforms.json``), cameras on three rings; returns the number
    of frames."""
    from gfnerf_tpu_torch.utils.image_io import write_png
    from gfnerf_tpu_torch.utils.synthetic import (render_textured_scene,
                                                  ring_cameras)

    rings = [
        dict(radius=4.0, height=1.2, focal=140.0),
        dict(radius=5.5, height=2.4, focal=140.0),
        dict(radius=7.0, height=3.8, focal=140.0),
    ]
    per = n_cams // len(rings)
    c2ws, fxs, fys, cxs, cys = [], [], [], [], []
    for r in rings:
        c2w, fx, fy, cx, cy, w, h = ring_cameras(
            per, radius=r["radius"], height=r["height"], img_wh=img_wh,
            focal=r["focal"])
        c2ws.append(c2w)
        fxs.append(fx)
        fys.append(fy)
        cxs.append(cx)
        cys.append(cy)
    c2w = np.concatenate(c2ws)
    fx = np.concatenate(fxs)
    fy = np.concatenate(fys)
    cx = np.concatenate(cxs)
    cy = np.concatenate(cys)
    imgs = render_textured_scene(c2w, fx, fy, cx, cy, w, h)

    out = Path(out)
    (out / "images").mkdir(parents=True, exist_ok=True)
    frames = []
    for i in range(len(imgs)):
        name = f"images/frame_{i:05d}.png"
        write_png(out / name,
                  (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))
        m = np.eye(4)
        m[:3, :4] = c2w[i]
        frames.append({
            "file_path": name,
            "transform_matrix": m.tolist(),
            "fl_x": float(fx[i]), "fl_y": float(fy[i]),
            "cx": float(cx[i]), "cy": float(cy[i]),
            "w": int(w), "h": int(h),
        })
    (out / "transforms.json").write_text(json.dumps(
        {"camera_model": "OPENCV", "frames": frames}, indent=1))
    return len(imgs)


def _env() -> dict:
    """The environment with the repository first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def launch(cmd, log_path: Path) -> subprocess.Popen:
    """``cmd`` in a session of its own (so that ``kill_group`` reaches
    every process it starts), its output to ``log_path``."""
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=REPO, env=_env(), start_new_session=True)


def kill_group(proc: subprocess.Popen) -> None:
    """SIGTERM to ``proc``'s process group; SIGKILL after 20 s."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=20)
    except ProcessLookupError:
        pass


def last_step(log_path: Path) -> int:
    """The last ``[step N]`` the trainer logged, or -1."""
    if not log_path.exists():
        return -1
    steps = re.findall(r"\[step\s+(\d+)\]", log_path.read_text())
    return int(steps[-1]) if steps else -1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path,
                    default=Path("outputs/midscale"))
    ap.add_argument("--scene-dir", type=Path,
                    default=Path("outputs/midscale_scene"))
    ap.add_argument("--run-dir", type=Path,
                    default=Path("outputs/midscale_out"),
                    help="train's --output-dir")
    ap.add_argument("--init-steps", type=int, default=1500)
    ap.add_argument("--split-steps", type=int, default=500)
    ap.add_argument("--n-cams", type=int, default=96)
    ap.add_argument("--img-wh", default="200x150",
                    help="scene image size WxH")
    ap.add_argument("--fast", action="store_true",
                    help="tiny steps for a plumbing-only dry run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, args.overrides = ap.parse_known_args(argv)
    if args.fast:  # shrink only knobs the user left at their defaults
        if args.init_steps == 1500:
            args.init_steps = 200
        if args.split_steps == 500:
            args.split_steps = 80
    for name in ("out_dir", "scene_dir", "run_dir"):
        setattr(args, name, getattr(args, name).resolve())
    return args


def schedule(args) -> dict:
    total = args.init_steps + N_BLOCKS * args.split_steps
    return {"total": total,
            "save_every": max(args.split_steps // 2, 50),
            # kill mid-focal: inside block 1 of 4
            "kill_at": (args.init_steps + args.split_steps
                        + args.split_steps // 2)}


def train_command(args, python=None) -> list:
    """The train command line (``scripts/midscale_run.py``'s, through
    ``python -m gfnerf_tpu_torch.train``); ``python`` is the interpreter
    and its leading arguments (default ``[sys.executable]``)."""
    s = schedule(args)
    init, split = str(args.init_steps), str(args.split_steps)
    nb = str(N_BLOCKS)
    cmd = [
        *(python or [sys.executable]), "-m", "gfnerf_tpu_torch.train",
        "gf-nerf",
        "--data", str(args.scene_dir),
        "--dataparser", "nerfstudio",
        "--output-dir", str(args.run_dir),
        "--experiment-name", EXPERIMENT,
        "--max-num-iterations", str(s["total"]),
        "--vis", "local",
        "--device", args.device,
        # sized to trigger >= 2 milestone rebuilds during init
        "--pipeline.model.n_blocks", nb,
        "--pipeline.model.n_split_dataset", nb,
        "--pipeline.model.steps_perssampler_init", init,
        "--pipeline.model.steps_per_split_dataset", split,
        "--pipeline.model.scale_factor", "1.0",
        "--pipeline.datamanager.n_split_dataset", nb,
        "--pipeline.datamanager.steps_per_split_dataset", split,
        "--pipeline.datamanager.steps_perssampler_init", init,
        "--pipeline.optimizers.n_split_dataset", nb,
        "--pipeline.optimizers.steps_per_split_dataset", split,
        "--pipeline.optimizers.steps_perssampler_init", init,
        "--pipeline.sampler.sub_div_milestones",
        f"{args.init_steps // 8},{args.init_steps // 4},"
        f"{args.init_steps // 2}",
        "--pipeline.sampler.ray_march_fineness_decay_end_iter", init,
        "--pipeline.camera_bounds", "0.01,50.0",
        "--pipeline.field_num_levels", "8",
        "--pipeline.field_features_per_level", "4",
        "--pipeline.field_hash_layout", "packed",
        "--pipeline.field_mlp_dtype", "bfloat16",
        "--pipeline.model.samples_budget_per_ray", "384",
        "--pipeline.sampler.max_samples", "384",
        # start the padded octree small; the manager doubles its capacity
        # when a milestone rebuild outgrows it
        "--pipeline.sampler.node_capacity", "32768",
        # recompute the field in 8 ray chunks in the backward
        "--pipeline.model.remat_chunks", "8",
        "--steps_per_save", str(s["save_every"]),
        "--steps_per_eval_batch", "1000000000",
        "--steps_per_eval_image", "1000000000",
    ]
    if args.fast:  # plumbing-only dry run
        cmd += ["--pipeline.datamanager.train_num_rays_per_batch", "1024",
                "--pipeline.model.samples_budget_per_ray", "192",
                "--pipeline.sampler.max_samples", "192"]
    return cmd + list(args.overrides)


def eval_images(scene: Path) -> np.ndarray:
    """The eval split's images of the nerfstudio scene, (N, H, W, 3) in
    [0, 1], as the datamanager reads them."""
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.utils.image_io import read_image

    outs = build_dataparser("nerfstudio", scene).get_dataparser_outputs(
        "val")
    return np.stack([read_image(f)[..., :3].astype(np.float32) / 255.0
                     for f in outs.image_filenames])


def _s_per_step(text: str) -> float:
    """Median of the trainer's logged ``Train Iter (time)``."""
    times = [float(t) for t in
             re.findall(r"Train Iter \(time\): ([0-9.eE+-]+)", text)]
    return statistics.median(times) if times else float("nan")


def run(args, python=None, log=print) -> dict:
    """Both phases and the eval; writes and returns the summary.  Raises
    ``SystemExit`` where a phase fails as the JAX script does."""
    from gfnerf_tpu_torch.quality_run import trivial_baselines

    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    if not (args.scene_dir / "transforms.json").exists():
        log("building nerfstudio scene ...")
        w, h = (int(v) for v in args.img_wh.split("x"))
        n = build_nerfstudio_scene(args.scene_dir, n_cams=args.n_cams,
                                   img_wh=(w, h))
        log(f"wrote {n} frames to {args.scene_dir}")

    s = schedule(args)
    common = train_command(args, python)
    summary = {"total_steps": s["total"], "kill_at": s["kill_at"],
               "n_blocks": N_BLOCKS, "init_steps": args.init_steps}

    # ---- phase 1: train until mid-focal, then SIGTERM the group --------
    log1 = out / "train_phase1.log"
    log(f"phase 1: training to ~step {s['kill_at']}, then killing")
    t0 = time.time()
    p = launch(common, log1)
    while True:
        time.sleep(POLL_S)
        step = last_step(log1)
        if step >= 0:
            summary.setdefault("phase1_first_step_s", time.time() - t0)
        if p.poll() is not None:
            raise SystemExit(
                f"phase-1 process exited early (rc={p.returncode}); "
                f"see {log1}")
        if step >= s["kill_at"]:
            log(f"killing at logged step {step} "
                f"({(time.time() - t0) / 60:.1f} min)")
            kill_group(p)
            break
    summary["killed_at_logged_step"] = step
    summary["phase1_minutes"] = (time.time() - t0) / 60

    # ---- phase 2: resume from the latest checkpoint --------------------
    ckpt_root = args.run_dir / EXPERIMENT / "gf-nerf"
    load_dir = sorted(ckpt_root.glob("*/nerfstudio_models"))[-1]
    summary["resume_load_dir"] = str(load_dir)
    summary["resume_ckpts"] = sorted(
        q.name for q in load_dir.glob("step-*"))
    log2 = out / "train_phase2.log"
    log(f"phase 2: resuming from {load_dir}")
    t0 = time.time()
    p = launch(common + ["--load-dir", str(load_dir)], log2)
    while p.poll() is None:
        time.sleep(POLL_S)
        if "phase2_first_step_s" not in summary and last_step(log2) >= 0:
            summary["phase2_first_step_s"] = time.time() - t0
    rc = p.returncode
    summary["phase2_rc"] = rc
    summary["phase2_minutes"] = (time.time() - t0) / 60
    if rc != 0:
        raise SystemExit(f"phase-2 failed rc={rc}; see {log2}")
    resumed = re.findall(r"resumed from .* at step (\d+)", log2.read_text())
    summary["phase2_resumed_at"] = int(resumed[-1]) if resumed else -1

    # ---- eval -----------------------------------------------------------
    cfg = sorted(ckpt_root.glob("*/config.json"))[-1]
    summary["phase2_ckpts"] = sorted(
        q.name for q in (cfg.parent / "nerfstudio_models").glob("step-*"))
    eval_out = out / "midscale_eval.json"
    t0 = time.time()
    with open(out / "eval.log", "w") as eval_log:
        rc = subprocess.call(
            [*(python or [sys.executable]), "-m", "gfnerf_tpu_torch.eval",
             "--load-config", str(cfg), "--output-path", str(eval_out)],
            cwd=REPO, stdout=eval_log, stderr=subprocess.STDOUT,
            env=_env())
    summary["eval_rc"] = rc
    summary["eval_minutes"] = (time.time() - t0) / 60
    if eval_out.exists():
        summary["eval"] = json.loads(eval_out.read_text())
    summary["baselines"] = trivial_baselines(eval_images(args.scene_dir))

    # rebuild / recalibration evidence from the logs
    for name, path in (("phase1", log1), ("phase2", log2)):
        txt = path.read_text()
        summary[f"{name}_rebuilds"] = len(
            re.findall(r"milestone rebuild|proc_octree", txt))
        summary[f"{name}_max_hits_events"] = re.findall(
            r"auto-calibrated max_hits: \d+ -> \d+", txt)
        summary[f"{name}_s_per_step"] = _s_per_step(txt)
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("midscale_run: no CUDA card (pass --device cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 1
    summary = run(args, log=lambda msg: print(msg, flush=True))
    print(json.dumps(summary, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
