"""Convert captured data into a trainable nerfstudio-format dataset.

The port's counterpart of ``scripts/process_data.py`` (the reference's
``ns-process-data``):

  python -m gfnerf_tpu_torch.process_data MODE --data PATH
      --output-dir DIR [--colmap-model-dir DIR] [--num-frames-target N]
      [--metadata FILE] [--video-back FILE]

Modes: ``images-colmap`` (an existing COLMAP sparse model; running COLMAP
itself is out of scope), ``video`` (frames for COLMAP, decoded by
ffmpeg), ``polycam``, ``record3d``, ``metashape``, ``realitycapture``,
``insta360-images`` (decoded frames, PNG), ``insta360-video`` (ffmpeg) and
``hloc`` (with the hloc package installed).  The converters live in
``process_data/converters.py``.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

MODES = ["images-colmap", "video", "polycam", "record3d", "metashape",
         "realitycapture", "insta360-images", "insta360-video", "hloc"]


def _copy_images(src: Path, out: Path) -> dict:
    """``src`` copied to ``out/images`` (unless there already): {stem:
    path relative to ``out``}."""
    img_out = out / "images"
    if not img_out.exists():
        shutil.copytree(src, img_out)
    return {f.stem: Path("images") / f.name
            for f in sorted(img_out.iterdir())}


def extract_video_frames(video: Path, img_out: Path,
                         num_frames_target: int) -> int:
    """Every ``total // num_frames_target``-th frame of a video (at least
    every frame) as ``img_out/frame_%05d.png`` from 0.  Returns the
    count."""
    from gfnerf_tpu_torch.process_data.converters import decode_video_frames

    img_out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        frames = decode_video_frames(video, Path(td))
        step = max(len(frames) // num_frames_target, 1)
        kept = frames[::step]
        for i, f in enumerate(kept):
            shutil.move(str(f), img_out / f"frame_{i:05d}.png")
    return len(kept)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=MODES)
    parser.add_argument("--data", type=Path, required=True,
                        help="image directory, capture directory or video")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--colmap-model-dir", type=Path, default=None,
                        help="COLMAP sparse model directory "
                             "(cameras/images .bin or .txt)")
    parser.add_argument("--num-frames-target", type=int, default=300)
    parser.add_argument("--metadata", type=Path, default=None,
                        help="record3d metadata.json, metashape cameras.xml "
                             "or realitycapture csv")
    parser.add_argument("--video-back", type=Path, default=None,
                        help="insta360-video: the back lens's video (omit "
                             "for a single-file dual-fisheye capture)")
    args = parser.parse_args(argv)

    from gfnerf_tpu_torch.process_data import converters

    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    if args.mode == "images-colmap":
        if args.colmap_model_dir is None:
            parser.error("images-colmap needs --colmap-model-dir")
        from gfnerf_tpu_torch.process_data.colmap_utils import colmap_to_json

        _copy_images(args.data, out)
        n = colmap_to_json(args.colmap_model_dir, out)
        lines = [f"wrote transforms.json with {n} frames to {out}"]
    elif args.mode == "polycam":
        # the polycam export's layout: keyframes/images, keyframes/cameras
        img_dir = args.data / "keyframes" / "images"
        cam_dir = args.data / "keyframes" / "cameras"
        imgs = sorted(img_dir.iterdir())
        img_out = out / "images"
        img_out.mkdir(exist_ok=True)
        for i, f in enumerate(imgs):
            shutil.copy(f, img_out / f"frame_{i+1:05d}{f.suffix}")
        lines = converters.polycam_to_json(imgs, cam_dir, out)
    elif args.mode == "record3d":
        if args.metadata is None:
            parser.error("record3d needs --metadata metadata.json")
        imgs = sorted(args.data.iterdir())
        img_out = out / "images"
        img_out.mkdir(exist_ok=True)
        rels = []
        for i, f in enumerate(imgs):
            dst = img_out / f"frame_{i+1:05d}{f.suffix}"
            shutil.copy(f, dst)
            rels.append(Path("images") / dst.name)
        n = converters.record3d_to_json(rels, args.metadata, out,
                                        np.arange(len(rels)))
        lines = [f"wrote transforms.json with {n} frames"]
    elif args.mode == "metashape":
        if args.metadata is None:
            parser.error("metashape needs --metadata cameras.xml")
        lines = converters.metashape_to_json(
            _copy_images(args.data, out), args.metadata, out)
    elif args.mode == "realitycapture":
        if args.metadata is None:
            parser.error("realitycapture needs --metadata poses.csv")
        lines = converters.realitycapture_to_json(
            _copy_images(args.data, out), args.metadata, out)
    elif args.mode == "insta360-images":
        # decoded frames: front/ and back/ (a two-file capture) or flat
        # dual-fisheye frames (a single-file one)
        img_out = out / "images"
        if (args.data / "front").is_dir():
            lines = converters.insta360_frames_to_images(
                sorted((args.data / "front").iterdir()),
                sorted((args.data / "back").iterdir()),
                img_out, args.num_frames_target)
        else:
            lines = converters.insta360_single_frames_to_images(
                sorted(p for p in args.data.iterdir() if p.is_file()),
                img_out, args.num_frames_target)
        lines.append("now run COLMAP (fisheye camera model) on the frames, "
                     "then re-run with mode=images-colmap")
    elif args.mode == "insta360-video":
        lines = converters.insta360_to_images(
            args.data, args.video_back, out / "images",
            args.num_frames_target)
        lines.append("now run COLMAP (fisheye camera model) on the frames, "
                     "then re-run with mode=images-colmap")
    elif args.mode == "hloc":
        img_out = out / "images"
        if not img_out.exists():
            shutil.copytree(args.data, img_out)
        lines = converters.hloc_to_json(img_out, out)
    else:
        n = extract_video_frames(args.data, out / "images",
                                 args.num_frames_target)
        lines = [f"extracted {n} frames to {out / 'images'}; run COLMAP on "
                 "them, then re-run with mode=images-colmap"]
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
