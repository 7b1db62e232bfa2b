"""Render a camera trajectory from a trained checkpoint.

The port's counterpart of ``scripts/render.py`` (the reference's
RenderTrajectory, render.py:47-365): a camera-path JSON, a trajectory
interpolated through the eval cameras or a spiral around the first one; an
optional appearance index per frame (``--embedding-indices``); the
two-phase early-termination renderer (``--early-term``).  Frames are
written as PNG files by ``utils/image_io.py``'s writer on the standard
library's ``zlib``, or with ``--output-format video`` as ``render.mp4``:
24 fps Motion-JPEG (``utils/video.py``; each frame encoded by the port's
JPEG codec as it is rendered) where the JAX script writes ``mp4v`` through
``cv2`` (the card's machine has neither ``imageio`` nor ``cv2``).

  python -m gfnerf_tpu_torch.render --load-config RUN/config.json
      [--traj {spiral,interpolate,filename}] [--spiral-steps N]
      [--camera-path-filename PATH] [--output-path DIR]
      [--output-format {images,video}]
      [--downscale-factor K] [--embedding-indices I ...]
      [--early-term] [--et-eps EPS]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import CamerasHost
from gfnerf_tpu_torch.train import DATAPARSERS
# the PNG codec lives in utils/image_io.py; these names stay importable here
from gfnerf_tpu_torch.utils.image_io import read_png, write_png  # noqa: F401


def cameras_from_camera_path(path_json: dict) -> CamerasHost:
    """A nerfstudio camera_path.json as host cameras."""
    frames = path_json["camera_path"]
    h = int(path_json["render_height"])
    w = int(path_json["render_width"])
    c2w = np.stack([np.array(fr["camera_to_world"], dtype=np.float32)
                    .reshape(4, 4)[:3, :4] for fr in frames])
    n = len(c2w)
    fov = np.asarray([float(fr["fov"]) for fr in frames], np.float32)
    focal = h / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    return CamerasHost(
        camera_to_worlds=c2w, fx=focal, fy=focal,
        cx=np.full(n, w / 2.0, np.float32),
        cy=np.full(n, h / 2.0, np.float32),
        width=np.full(n, w, np.int32), height=np.full(n, h, np.int32))


def spiral_cameras(cams: CamerasHost, steps: int = 30, radius: float = 0.1,
                   rots: int = 2, zrate: float = 0.5) -> CamerasHost:
    """A spiral around the first camera (nerfstudio
    cameras/camera_paths.py:150-215): circular offsets with a z
    oscillation in the camera's frame, each looking at a point ``focal``
    units down its -z axis."""

    def viewmatrix(lookdir, up, position):
        vec2 = lookdir / np.linalg.norm(lookdir)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        vec1 = vec1 / np.linalg.norm(vec1)
        return np.stack([vec0, vec1, vec2, position], axis=1)

    c2w0 = np.asarray(cams.camera_to_worlds[0])
    up = c2w0[:3, 2]
    focal = float(min(cams.fx[0], cams.fy[0]))
    target = np.array([0.0, 0.0, -focal])
    c2wh0 = np.concatenate([c2w0, [[0, 0, 0, 1]]], axis=0)
    poses = []
    for theta in np.linspace(0.0, 2 * np.pi * rots, steps + 1)[:-1]:
        center = np.array([np.cos(theta), -np.sin(theta),
                           -np.sin(theta * zrate)]) * radius
        local = viewmatrix(center - target, up, center)
        localh = np.concatenate([local, [[0, 0, 0, 1]]], axis=0)
        poses.append((c2wh0 @ localh)[:3, :4])
    n = len(poses)

    def rep(v):
        return np.full(n, v)

    return CamerasHost(
        camera_to_worlds=np.stack(poses).astype(np.float32),
        fx=rep(float(cams.fx[0])), fy=rep(float(cams.fy[0])),
        cx=rep(float(cams.cx[0])), cy=rep(float(cams.cy[0])),
        width=np.full(n, int(cams.width[0]), np.int32),
        height=np.full(n, int(cams.height[0]), np.int32))


def interpolate_cameras(cams: CamerasHost,
                        steps_per_transition: int = 10) -> CamerasHost:
    """A trajectory through the cameras in order: rotations by spherical
    interpolation (scipy's ``Slerp``), positions linearly; the first
    camera's intrinsics."""
    from scipy.spatial.transform import Rotation, Slerp

    c2w = cams.camera_to_worlds
    out = []
    for i in range(len(cams) - 1):
        slerp = Slerp([0, 1], Rotation.from_matrix(
            np.stack([c2w[i, :3, :3], c2w[i + 1, :3, :3]])))
        for t in np.linspace(0, 1, steps_per_transition, endpoint=False):
            pos = (1 - t) * c2w[i, :3, 3] + t * c2w[i + 1, :3, 3]
            out.append(np.concatenate([slerp(t).as_matrix(), pos[:, None]],
                                      axis=-1))
    return dataclasses.replace(
        cams[np.zeros(len(out), np.int64)],
        camera_to_worlds=np.stack(out).astype(np.float32))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--traj", default="spiral",
                        choices=["spiral", "interpolate", "filename"])
    parser.add_argument("--spiral-steps", type=int, default=30)
    parser.add_argument("--spiral-radius", type=float, default=0.1)
    parser.add_argument("--camera-path-filename", type=Path, default=None)
    parser.add_argument("--output-path", type=Path, default=Path("renders"))
    parser.add_argument("--output-format", default="images",
                        choices=["images", "video"])
    parser.add_argument("--downscale-factor", type=int, default=1)
    parser.add_argument("--embedding-indices", type=int, nargs="*",
                        default=None)
    parser.add_argument("--dataparser", default=None,
                        choices=DATAPARSERS,
                        help="default: guessed from the run's data "
                             "directory")
    parser.add_argument("--early-term", action="store_true",
                        help="two-phase early-termination rendering "
                             "(models/render_early.py): saturated rays skip "
                             "their tail samples; exact to --et-eps")
    parser.add_argument("--et-eps", type=float, default=None,
                        help="termination transmittance threshold "
                             "(default: the pipeline config's, 5e-3)")
    args = parser.parse_args(argv)
    if args.output_format == "video":
        from gfnerf_tpu_torch.ops.build import jpeg_library

        jpeg_library()      # a codec that cannot build fails before rendering
    if args.traj == "filename" and args.camera_path_filename is None:
        parser.error("--traj filename needs --camera-path-filename")

    from gfnerf_tpu_torch.utils.eval_utils import eval_setup

    _, trainer = eval_setup(args.load_config, args.dataparser)
    pipeline = trainer.pipeline
    if args.early_term:
        pipeline.enable_early_term(eps=args.et_eps)
    step = int(pipeline.state.step)
    if args.traj == "filename":
        cams = cameras_from_camera_path(
            json.loads(args.camera_path_filename.read_text()))
    else:
        eval_cams = (pipeline.datamanager.eval_dataparser_outputs.cameras
                     if hasattr(pipeline, "datamanager")
                     else pipeline.eval_outputs.cameras)
        cams = (interpolate_cameras(eval_cams) if args.traj == "interpolate"
                else spiral_cameras(eval_cams, steps=args.spiral_steps,
                                    radius=args.spiral_radius))
    cams_dev = cams.to_device(pipeline.device)
    args.output_path.mkdir(parents=True, exist_ok=True)
    video = None
    if args.output_format == "video":
        from gfnerf_tpu_torch.utils.video import Mp4Writer

        video = Mp4Writer(args.output_path / "render.mp4", fps=24)
    for i in range(len(cams)):
        rel = (args.embedding_indices[i % len(args.embedding_indices)]
               if args.embedding_indices else None)
        out = pipeline.render_camera(cams, cams_dev, i, step,
                                     downscale=args.downscale_factor,
                                     rel_camera_index=rel)
        rgb = (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8)
        if video is None:
            write_png(args.output_path / f"{i:05d}.png", rgb)
        else:
            video.add(rgb)
        print(f"rendered frame {i + 1}/{len(cams)}")
    if video is not None:
        print(f"wrote {video.close()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
