"""The instant-ngp, D-NeRF and DyCheck dataset formats.

Port of ``InstantNGPDataParser``, ``DNeRFDataParser``,
``DycheckDataParser`` and their helpers from
``gfnerf_tpu/data/dataparsers/extra_parsers.py`` (nerfstudio's
``instant_ngp_dataparser.py``, ``dnerf_dataparser.py`` and
``dycheck_dataparser.py``): instant-ngp's fov/fl focal fallbacks, OpenCV
distortion from top-level keys, an ``aabb_scale`` scene box and the
fisheye flag; D-NeRF's Blender-style splits with a ``time`` a frame;
DyCheck's iphone layout (split frame lists, a camera file a frame, the
scene's scale).  The two dynamic formats give each frame's time in
``metadata["times"]`` (DyCheck's time ids divided by the largest), which
the nerfplayer pair reads.  An image's size comes from its PNG header
where the format does not give it (``image_io.image_size``).  The JAX
module's other six parsers (scannet, sdfstudio, phototourism, sitcoms3d,
arkitscenes, nuscenes) are not ported.
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


@dataclasses.dataclass
class DNeRFDataParserConfig:
    data: Path = Path("data")
    scale_factor: float = 1.0


class DNeRFDataParser(DataParser):
    """D-NeRF's Blender-style dynamic dataset (dnerf_dataparser.py:63-111):
    ``transforms_{split}.json`` with a ``time`` a frame, into
    ``metadata["times"]``."""

    def _generate_dataparser_outputs(self, split="train"):
        data = Path(self.config.data)
        split_name = {"val": "val", "test": "test"}.get(split, "train")
        meta = _load_json(data / f"transforms_{split_name}.json")
        image_filenames, poses, times = [], [], []
        for frame in meta["frames"]:
            image_filenames.append(
                data / (frame["file_path"].replace("./", "") + ".png"))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
            times.append(float(frame["time"]))
        poses = np.stack(poses)
        w, h = _image_size(image_filenames[0])
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        poses[:, :3, 3] *= self.config.scale_factor
        n = len(image_filenames)
        cameras = CamerasHost(
            camera_to_worlds=poses[:, :3, :4],
            fx=np.full(n, focal, np.float32), fy=np.full(n, focal, np.float32),
            cx=np.full(n, w / 2.0, np.float32),
            cy=np.full(n, h / 2.0, np.float32),
            width=np.full(n, w, np.int32), height=np.full(n, h, np.int32),
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=_cube_box(1.5),
            dataparser_scale=self.config.scale_factor,
            metadata={"times": np.asarray(times, np.float32)},
        )


@dataclasses.dataclass
class DycheckDataParserConfig:
    data: Path = Path("data")
    scale_factor: float = 5.0
    downscale_factor: int = 1
    scene_box_bound: float = 1.5


class DycheckDataParser(DataParser):
    """DyCheck's iphone subset (dycheck_dataparser.py:200-342):
    ``splits/{split}.json`` frame lists with time ids, a
    ``camera/{frame}.json`` a frame (OpenCV orientation, focal length,
    principal point), the scene's centre and scale from ``scene.json``,
    the frames' depth ``.npy`` files where they exist."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        extra = _load_json(data / "extra.json")
        scene = _load_json(data / "scene.json")
        center = np.asarray(scene["center"], np.float32)
        scene_scale = float(scene["scale"])
        far = float(scene["far"])

        splits_dir = data / "splits"
        split_file = splits_dir / f"{split}.json"
        if not split_file.exists():
            split_file = splits_dir / "train.json"
        split_dict = _load_json(split_file)
        frame_names = list(split_dict["frame_names"])
        time_ids = np.asarray(split_dict["time_ids"], np.float32)
        if not frame_names:
            train = _load_json(splits_dir / "train.json")
            frame_names = list(train["frame_names"])[:1]
            time_ids = np.asarray(train["time_ids"], np.float32)[:1]

        sf = cfg.scene_box_bound / 4 / (scene_scale * far)
        d = max(int(cfg.downscale_factor), 1) * int(extra.get("factor", 1))

        image_filenames, depth_filenames = [], []
        fx, fy, cx, cy, ws, hs, c2ws = [], [], [], [], [], [], []
        for name in frame_names:
            cam = _load_json(data / "camera" / f"{name}.json")
            image_filenames.append(data / f"rgb/{d}x" / f"{name}.png")
            depth_np = data / f"depth/{d}x" / f"{name}.npy"
            if depth_np.exists():
                depth_filenames.append(depth_np)
            rot = np.asarray(cam["orientation"], np.float64)  # w2c rows
            c2w = np.eye(4)
            c2w[:3, :3] = rot.T
            c2w[:3, 3] = np.asarray(cam["position"], np.float64)
            c2w[0:3, 1:3] *= -1                     # OpenCV -> nerfstudio
            c2w[:3, 3] = (c2w[:3, 3] - center) * scene_scale * sf
            c2ws.append(c2w.astype(np.float32))
            fx.append(cam["focal_length"] / d)
            fy.append(cam["focal_length"] * cam.get("pixel_aspect_ratio", 1.0)
                      / d)
            cx.append(cam["principal_point"][0] / d)
            cy.append(cam["principal_point"][1] / d)
            ws.append(int(cam["image_size"][0] // d))
            hs.append(int(cam["image_size"][1] // d))

        c2ws = np.stack(c2ws)
        cameras = CamerasHost(
            camera_to_worlds=c2ws[:, :3, :4],
            fx=np.asarray(fx, np.float32), fy=np.asarray(fy, np.float32),
            cx=np.asarray(cx, np.float32), cy=np.asarray(cy, np.float32),
            width=np.asarray(ws, np.int32), height=np.asarray(hs, np.int32),
        )
        tmax = float(time_ids.max()) or 1.0
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=_cube_box(cfg.scene_box_bound),
            dataparser_scale=scene_scale * sf,
            metadata={
                "times": time_ids / tmax,
                "depth_filenames": depth_filenames or None,
            },
        )
