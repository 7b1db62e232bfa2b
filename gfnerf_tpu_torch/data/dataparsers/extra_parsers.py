"""The instant-ngp dataset format.

Port of ``InstantNGPDataParser`` and its helpers from
``gfnerf_tpu/data/dataparsers/extra_parsers.py`` (nerfstudio's
``instant_ngp_dataparser.py``): fov/fl focal fallbacks, OpenCV distortion
from top-level keys, an ``aabb_scale`` scene box and the fisheye flag.
An image's size comes from its PNG header where the transforms do not
give it (``image_io.image_size``).  The JAX module's other eight parsers
(dnerf, scannet, sdfstudio, phototourism, sitcoms3d, arkitscenes,
nuscenes, dycheck) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (
    CamerasHost,
    DataParser,
    DataparserOutputs,
    SceneBox,
)
from gfnerf_tpu_torch.utils.camera_utils import get_distortion_params
# (width, height) of an image file
from gfnerf_tpu_torch.utils.image_io import image_size as _image_size

CAMERA_PERSPECTIVE = 0
CAMERA_FISHEYE = 1


def _load_json(path: Path):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _linspace_split(n: int, fraction: float, split: str) -> np.ndarray:
    """Equally-spaced train indices + the rest for eval (the scheme shared by
    scannet/phototourism/arkitscenes/nuscenes parsers, e.g.
    scannet_dataparser.py:103-117)."""
    n_train = math.ceil(n * fraction)
    i_all = np.arange(n)
    i_train = np.linspace(0, n - 1, n_train, dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)
    if split == "train":
        return i_train
    if split in ("val", "test"):
        return i_eval if len(i_eval) else i_train[:1]
    raise ValueError(f"unknown split {split!r}")


def _cube_box(half: float) -> SceneBox:
    return SceneBox(aabb=np.array([[-half] * 3, [half] * 3], np.float32))


@dataclasses.dataclass
class InstantNGPDataParserConfig:
    data: Path = Path("data")
    scene_scale: float = 0.3333
    train_split_fraction: float = 0.9


class InstantNGPDataParser(DataParser):
    """instant-ngp ``transforms.json`` (reference
    instant_ngp_dataparser.py:59-150): fov/fl focal fallbacks, OpenCV
    distortion from top-level keys, aabb_scale scene box, fisheye flag."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        if data.suffix == ".json":
            meta, data_dir = _load_json(data), data.parent
        else:
            meta, data_dir = _load_json(data / "transforms.json"), data

        image_filenames, poses = [], []
        for frame in meta["frames"]:
            fname = data_dir / frame["file_path"]
            if not fname.exists():
                fname = data_dir / (frame["file_path"] + ".png")
            if not fname.exists():
                continue
            if "w" not in meta:
                meta["w"], meta["h"] = _image_size(fname)
            image_filenames.append(fname)
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        assert image_filenames, "no images found via transforms.json"
        poses = np.stack(poses)
        poses[:, :3, 3] *= cfg.scene_scale

        w, h = int(meta["w"]), int(meta["h"])
        fl_x, fl_y = self._focal_lengths(meta, w, h)
        dist = get_distortion_params(
            k1=float(meta.get("k1", 0)), k2=float(meta.get("k2", 0)),
            k3=float(meta.get("k3", 0)), k4=float(meta.get("k4", 0)),
            p1=float(meta.get("p1", 0)), p2=float(meta.get("p2", 0)))
        n = len(image_filenames)
        idx = _linspace_split(n, self.config.train_split_fraction, split)
        cameras = CamerasHost(
            camera_to_worlds=poses[idx, :3, :4],
            fx=np.full(n, fl_x, np.float32)[idx],
            fy=np.full(n, fl_y, np.float32)[idx],
            cx=np.full(n, float(meta.get("cx", 0.5 * w)), np.float32)[idx],
            cy=np.full(n, float(meta.get("cy", 0.5 * h)), np.float32)[idx],
            width=np.full(n, w, np.int32)[idx],
            height=np.full(n, h, np.int32)[idx],
            distortion_params=np.tile(dist[None], (n, 1))[idx],
            camera_type=(CAMERA_FISHEYE if meta.get("is_fisheye", False)
                         else CAMERA_PERSPECTIVE),
        )
        half = 0.5 * float(meta.get("aabb_scale", 1))
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube_box(half),
            dataparser_scale=cfg.scene_scale,
            metadata={"global_image_indices": idx.tolist()},
        )

    @staticmethod
    def _focal_lengths(meta, w, h):
        # instant_ngp_dataparser.py:152-185
        def fov_to_fl(rad, res):
            return 0.5 * res / np.tan(0.5 * rad)

        fl_x = fl_y = 0.0
        if "fl_x" in meta:
            fl_x = meta["fl_x"]
        elif "x_fov" in meta:
            fl_x = fov_to_fl(np.deg2rad(meta["x_fov"]), w)
        elif "camera_angle_x" in meta:
            fl_x = fov_to_fl(meta["camera_angle_x"], w)
        if "fl_y" in meta:
            fl_y = meta["fl_y"]
        elif "y_fov" in meta:
            fl_y = fov_to_fl(np.deg2rad(meta["y_fov"]), h)
        elif "camera_angle_y" in meta:
            fl_y = fov_to_fl(meta["camera_angle_y"], h)
        fl_y = fl_y or fl_x
        if not fl_x or not fl_y:
            raise AttributeError("no focal length derivable from transforms")
        return float(fl_x), float(fl_y)
