"""Nerfstudio ``transforms.json`` dataparser.

Port of ``gfnerf_tpu/data/dataparsers/nerfstudio_parser.py`` (the
reference's extended parser, ``gfnerf/ori_dataparser.py``):
sorted frames (:128), per-frame or shared intrinsics, vertical orientation +
pose auto-scale x scale_factor (:264-282), scene-center shift, linspaced
train/eval split (:240-256), side-channel files (depth / normal / road_mask /
all_mask) and ``global_image_indices`` metadata (:367) feeding
``rel_camera_idx``; with ``downscale_factor`` the ``images_{df}``
directory where it exists, and the camera model (perspective with
distortion, fisheye, equirectangular) from ``camera_model``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (
    CamerasHost,
    DataParser,
    DataparserOutputs,
    SceneBox,
)
from gfnerf_tpu_torch.utils.camera_utils import auto_orient_and_center_poses

CAMERA_MODEL_TO_TYPE = {
    "OPENCV": 0, "PERSPECTIVE": 0, "OPENCV_FISHEYE": 1, "EQUIRECTANGULAR": 2,
}


@dataclasses.dataclass
class NerfstudioDataParserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0          # additional pose scale (GF-NeRF: 10.0)
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "vertical"   # "pca" | "up" | "vertical" | "none"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 1.0
    scene_center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    depth_unit_scale_factor: float = 1e-3


class NerfstudioDataParser(DataParser):
    config: NerfstudioDataParserConfig

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data_dir = Path(cfg.data)
        meta_path = data_dir / "transforms.json"
        meta = json.loads(meta_path.read_text())

        frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])

        def get(fr, key, default=None):
            return fr.get(key, meta.get(key, default))

        image_filenames, poses = [], []
        fx, fy, cx, cy, ws, hs, dist = [], [], [], [], [], [], []
        side = {k: [] for k in ("depth", "normal", "road_mask", "all_mask", "mask")}
        side_keys = {
            "depth": "depth_file_path", "normal": "normal_file_path",
            "road_mask": "road_mask_path", "all_mask": "all_mask_path",
            "mask": "mask_path",
        }
        for fr in frames:
            fname = self._get_fname(Path(fr["file_path"]), data_dir)
            image_filenames.append(fname)
            poses.append(np.array(fr["transform_matrix"], dtype=np.float64))
            fx.append(float(get(fr, "fl_x")))
            fy.append(float(get(fr, "fl_y")))
            cx.append(float(get(fr, "cx")))
            cy.append(float(get(fr, "cy")))
            ws.append(int(get(fr, "w")))
            hs.append(int(get(fr, "h")))
            dist.append([float(get(fr, k, 0.0)) for k in
                         ("k1", "k2", "k3", "k4", "p1", "p2")])
            for name, key in side_keys.items():
                p = fr.get(key)
                side[name].append(data_dir / p if p is not None else None)

        num_images = len(image_filenames)
        num_train = math.ceil(num_images * cfg.train_split_fraction)
        i_all = np.arange(num_images)
        i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
        i_eval = np.setdiff1d(i_all, i_train)
        if len(i_eval) == 0:
            i_eval = np.array([0])  # fraction 1.0: reuse first frame for eval
        indices = i_train if split == "train" else i_eval

        poses = np.stack(poses)  # (N, 4, 4)
        poses, transform_matrix = auto_orient_and_center_poses(
            poses, method=cfg.orientation_method, center_method=cfg.center_method
        )
        scale = 1.0
        if cfg.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3])))
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale
        poses[:, 0, 3] -= cfg.scene_center[0]
        poses[:, 1, 3] -= cfg.scene_center[1]
        poses[:, 2, 3] -= cfg.scene_center[2]

        sel = lambda lst: [lst[i] for i in indices]
        have = lambda lst: any(x is not None for x in lst)

        aabb_scale = cfg.scene_scale
        scene_box = SceneBox(aabb=np.array(
            [[-aabb_scale] * 3, [aabb_scale] * 3], np.float32))

        df = cfg.downscale_factor or 1
        cameras = CamerasHost(
            camera_to_worlds=poses[indices, :3, :4].astype(np.float32),
            fx=np.asarray(fx, np.float32)[indices] / df,
            fy=np.asarray(fy, np.float32)[indices] / df,
            cx=np.asarray(cx, np.float32)[indices] / df,
            cy=np.asarray(cy, np.float32)[indices] / df,
            width=(np.asarray(ws, np.int32)[indices] // df),
            height=(np.asarray(hs, np.int32)[indices] // df),
            distortion_params=np.asarray(dist, np.float32)[indices],
            camera_type=CAMERA_MODEL_TO_TYPE.get(
                meta.get("camera_model", "PERSPECTIVE"), 0),
        )

        return DataparserOutputs(
            image_filenames=sel(image_filenames),
            cameras=cameras,
            scene_box=scene_box,
            mask_filenames=sel(side["mask"]) if have(side["mask"]) else None,
            dataparser_scale=scale,
            dataparser_transform=transform_matrix,
            metadata={
                "depth_filenames": sel(side["depth"]) if have(side["depth"]) else None,
                "normal_filenames": sel(side["normal"]) if have(side["normal"]) else None,
                "road_mask_filenames": sel(side["road_mask"]) if have(side["road_mask"]) else None,
                "all_mask_filenames": sel(side["all_mask"]) if have(side["all_mask"]) else None,
                "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
                "global_image_indices": [int(i) for i in indices],
            },
        )

    def _get_fname(self, filepath: Path, data_dir: Path) -> Path:
        df = self.config.downscale_factor
        if df is not None and df > 1:
            candidate = data_dir / f"images_{df}" / filepath.name
            if candidate.exists():
                return candidate
        p = data_dir / filepath
        return p
