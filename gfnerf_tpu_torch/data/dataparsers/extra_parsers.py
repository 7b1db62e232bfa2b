"""The remaining nerfstudio dataset formats.

Port of every parser of ``gfnerf_tpu/data/dataparsers/extra_parsers.py``
with its config and helpers (nerfstudio's ``*_dataparser.py``), host-side
numpy whose outputs equal the JAX module's:

- instant-ngp: fov/fl focal fallbacks, OpenCV distortion from top-level
  keys, an ``aabb_scale`` scene box and the fisheye flag;
- D-NeRF: Blender-style splits with a ``time`` a frame;
- ScanNet: ``color/``, ``depth/``, ``pose/`` and the colour intrinsics;
  non-finite poses skipped; depth files and their unit in the metadata;
- SDFStudio: ``meta_data.json`` with per-frame intrinsics, the mono depth
  and normal priors, an optional auto-orient;
- Phototourism: COLMAP's binary model (``process_data/colmap_utils.py``),
  PINHOLE cameras, world-to-camera inverted, auto-oriented and scaled;
- Sitcoms3D: ``cameras.json`` with a box, the panoptic "thing" classes
  (semantics files ``.jpg`` -> ``.png``);
- ARKitScenes: the ``lowres_wide`` export, ``.traj`` poses with the
  nearest timestamp's as a fallback, ``.pincam`` intrinsics;
- nuScenes: the raw JSON tables joined without the devkit, masks;
- DyCheck: the iphone layout (split frame lists, a camera file a frame,
  the scene's scale).

The two dynamic formats give each frame's time in ``metadata["times"]``
(DyCheck's time ids divided by the largest), which the nerfplayer pair
reads.  Where a format does not give an image's size it comes from the
file's header (``image_io.image_size``: a PNG's IHDR, a JPEG's
start-of-frame), as the JAX module's ``cv2.imread`` gives it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (
    CamerasHost,
    DataParser,
    DataparserOutputs,
    SceneBox,
)
from gfnerf_tpu_torch.process_data.colmap_utils import (qvec2rotmat,
                                                        read_cameras_bin,
                                                        read_images_bin)
from gfnerf_tpu_torch.utils.camera_utils import (auto_orient_and_center_poses,
                                                 get_distortion_params)
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


def _quat_wxyz_to_rotmat(q) -> np.ndarray:
    w, x, y, z = [float(v) for v in q]
    n = math.sqrt(w * w + x * x + y * y + z * z) or 1.0
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


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
class ScanNetDataParserConfig:
    data: Path = Path("data")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3


class ScanNetDataParser(DataParser):
    """ScanNet dense export: color/ depth/ pose/ dirs + intrinsic txt
    (scannet_dataparser.py:72-173). Pose convention: flip y/z columns, swap
    x/y rows, negate z row; skips non-finite poses."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        by_num = lambda p: int(p.name.split(".")[0])
        imgs = sorted((data / "color").iterdir(), key=by_num)
        depths = sorted((data / "depth").iterdir(), key=by_num)
        pose_files = sorted((data / "pose").iterdir(), key=by_num)
        w, h = _image_size(imgs[0])
        K = np.loadtxt(data / "intrinsic" / "intrinsic_color.txt")

        image_filenames, depth_filenames, poses = [], [], []
        for img, depth, pf in zip(imgs, depths, pose_files):
            pose = np.loadtxt(pf)
            pose[0:3, 1:3] *= -1
            pose = pose[np.array([1, 0, 2, 3]), :]
            pose[2, :] *= -1
            if not np.isfinite(pose).all():
                continue
            poses.append(pose)
            image_filenames.append(img)
            depth_filenames.append(depth)

        idx = _linspace_split(len(image_filenames),
                              cfg.train_split_fraction, split)
        poses = np.stack(poses).astype(np.float32)
        poses, transform = auto_orient_and_center_poses(
            poses, method="none", center_method=cfg.center_method)
        scale = 1.0
        if cfg.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale

        n = len(idx)
        cameras = CamerasHost(
            camera_to_worlds=poses[idx, :3, :4],
            fx=np.full(n, K[0, 0], np.float32),
            fy=np.full(n, K[1, 1], np.float32),
            cx=np.full(n, K[0, 2], np.float32),
            cy=np.full(n, K[1, 2], np.float32),
            width=np.full(n, w, np.int32), height=np.full(n, h, np.int32),
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube_box(cfg.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
            metadata={
                "depth_filenames": [depth_filenames[i] for i in idx],
                "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
            },
        )


@dataclasses.dataclass
class SDFStudioDataParserConfig:
    data: Path = Path("data")
    skip_every_for_val_split: int = 1
    auto_orient: bool = False
    include_mono_prior: bool = False


class SDFStudioDataParser(DataParser):
    """SDFStudio ``meta_data.json`` (sdfstudio_dataparser.py:67-158):
    per-frame intrinsics + camtoworld, OpenCV->nerfstudio flip, scene box
    from metadata, optional mono depth/normal priors."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        meta = _load_json(data / "meta_data.json")
        indices = list(range(len(meta["frames"])))
        if split != "train" and cfg.skip_every_for_val_split >= 1:
            indices = indices[:: cfg.skip_every_for_val_split]

        image_filenames, depth_filenames, normal_filenames = [], [], []
        fx, fy, cx, cy, c2ws = [], [], [], [], []
        for i, frame in enumerate(meta["frames"]):
            if i not in indices:
                continue
            image_filenames.append(data / frame["rgb_path"])
            if frame.get("mono_depth_path"):
                depth_filenames.append(data / frame["mono_depth_path"])
            if frame.get("mono_normal_path"):
                normal_filenames.append(data / frame["mono_normal_path"])
            K = np.asarray(frame["intrinsics"], np.float32)
            fx.append(K[0, 0]); fy.append(K[1, 1])
            cx.append(K[0, 2]); cy.append(K[1, 2])
            c2ws.append(np.asarray(frame["camtoworld"], np.float32))
        c2ws = np.stack(c2ws)
        c2ws[:, 0:3, 1:3] *= -1  # OpenCV -> nerfstudio
        transform = None
        if cfg.auto_orient:
            c2ws4 = np.concatenate(
                [c2ws[:, :3, :4],
                 np.tile(np.array([[[0, 0, 0, 1]]], np.float32),
                         (len(c2ws), 1, 1))], axis=1)
            c2ws, transform = auto_orient_and_center_poses(
                c2ws4, method="up", center_method="none")
        n = len(image_filenames)
        cameras = CamerasHost(
            camera_to_worlds=c2ws[:, :3, :4],
            fx=np.asarray(fx), fy=np.asarray(fy),
            cx=np.asarray(cx), cy=np.asarray(cy),
            width=np.full(n, int(meta["width"]), np.int32),
            height=np.full(n, int(meta["height"]), np.int32),
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(
                aabb=np.asarray(meta["scene_box"]["aabb"], np.float32)),
            dataparser_transform=transform,
            metadata={
                "depth_filenames": depth_filenames or None,
                "normal_filenames": normal_filenames or None,
            },
        )


@dataclasses.dataclass
class PhototourismDataParserConfig:
    data: Path = Path("data")
    scale_factor: float = 3.0
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9


class PhototourismDataParser(DataParser):
    """Phototourism COLMAP dense reconstructions
    (phototourism_dataparser.py:84-192): per-image PINHOLE intrinsics from
    ``dense/sparse/cameras.bin``, world-to-camera inversion, y/z flip, auto
    orient + scale, linspaced split."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        cams = read_cameras_bin(data / "dense/sparse/cameras.bin")
        imgs = read_images_bin(data / "dense/sparse/images.bin")
        img_by_cam = {im["camera_id"]: (iid, im) for iid, im in imgs.items()}

        poses, fxs, fys, cxs, cys, ws, hs, image_filenames = (
            [], [], [], [], [], [], [], [])
        for cid, cam in cams.items():
            if cid not in img_by_cam:
                continue
            _, img = img_by_cam[cid]
            assert cam["model"] == "PINHOLE", (
                "phototourism expects PINHOLE cameras")
            w2c = np.eye(4)
            w2c[:3, :3] = qvec2rotmat(img["qvec"])
            w2c[:3, 3] = img["tvec"]
            c2w = np.linalg.inv(w2c)
            c2w[:, 1:3] *= -1  # COLMAP -> nerfstudio
            poses.append(c2w)
            fxs.append(cam["params"][0]); fys.append(cam["params"][1])
            cxs.append(cam["params"][2]); cys.append(cam["params"][3])
            ws.append(cam["width"]); hs.append(cam["height"])
            image_filenames.append(data / "dense/images" / img["name"])

        poses = np.stack(poses).astype(np.float32)
        idx = _linspace_split(len(poses), cfg.train_split_fraction, split)
        poses, transform = auto_orient_and_center_poses(
            poses, method=cfg.orientation_method,
            center_method=cfg.center_method)
        scale = 1.0
        if cfg.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale

        cameras = CamerasHost(
            camera_to_worlds=poses[idx, :3, :4],
            fx=np.asarray(fxs, np.float32)[idx],
            fy=np.asarray(fys, np.float32)[idx],
            cx=np.asarray(cxs, np.float32)[idx],
            cy=np.asarray(cys, np.float32)[idx],
            width=np.asarray(ws, np.int32)[idx],
            height=np.asarray(hs, np.int32)[idx],
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube_box(cfg.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


@dataclasses.dataclass
class Sitcoms3DDataParserConfig:
    data: Path = Path("data")
    include_semantics: bool = False
    downscale_factor: int = 4
    scene_scale: float = 2.0


class Sitcoms3DDataParser(DataParser):
    """Sitcoms3D ``cameras.json`` (sitcoms3d_dataparser.py:67-156): bbox from
    metadata, z-up 90deg x-rotation, center + longest-dim normalization,
    optional panoptic "thing" segmentations."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        cameras_json = _load_json(data / "cameras.json")
        frames = cameras_json["frames"]
        bbox = np.asarray(cameras_json["bbox"], np.float32)

        sfx = f"_{cfg.downscale_factor}" if cfg.downscale_factor != 1 else ""
        images_folder = f"images{sfx}"

        image_filenames, fx, fy, cx, cy, c2ws = [], [], [], [], [], []
        for frame in frames:
            image_filenames.append(data / images_folder / frame["image_name"])
            K = np.asarray(frame["intrinsics"], np.float32)
            fx.append(K[0, 0]); fy.append(K[1, 1])
            cx.append(K[0, 2]); cy.append(K[1, 2])
            c2ws.append(np.asarray(frame["camtoworld"], np.float32)[:3])
        c2ws = np.stack(c2ws)

        rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
        c2ws[:, :3, :3] = rot @ c2ws[:, :3, :3]
        c2ws[:, :3, 3] = c2ws[:, :3, 3] @ rot.T
        bbox = bbox @ rot.T

        center = 0.5 * (bbox[0] + bbox[1])
        bbox = bbox - center
        c2ws[..., 3] -= center
        lengths = bbox[1] - bbox[0]
        scale = cfg.scene_scale / float(lengths.max())
        bbox *= scale
        c2ws[..., 3] *= scale

        n = len(image_filenames)
        d = float(cfg.downscale_factor)
        cameras = CamerasHost(
            camera_to_worlds=c2ws,
            fx=np.asarray(fx) / d, fy=np.asarray(fy) / d,
            cx=np.asarray(cx) / d, cy=np.asarray(cy) / d,
            # image sizes follow the downscaled images on disk
            width=(np.asarray([_image_size(f)[0] for f in
                               image_filenames[:1]] * n, np.int32)),
            height=(np.asarray([_image_size(f)[1] for f in
                                image_filenames[:1]] * n, np.int32)),
        )
        metadata = {}
        if cfg.include_semantics:
            seg_folder = f"segmentations{sfx}"
            metadata["semantics_filenames"] = [
                Path(str(f).replace(images_folder, f"{seg_folder}/thing")
                     .replace(".jpg", ".png")) for f in image_filenames]
            pano = _load_json(data / "panoptic_classes.json")
            metadata["semantics_classes"] = pano["thing"]
            metadata["semantics_colors"] = (
                np.asarray(pano["thing_colors"], np.float32) / 255.0)
            metadata["semantics_mask_classes"] = ["person"]
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(aabb=np.stack([bbox[0], bbox[1]])),
            metadata=metadata,
        )


@dataclasses.dataclass
class ARKitScenesDataParserConfig:
    data: Path = Path("data")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3


def _traj_line_to_pose(line: str) -> np.ndarray:
    """ARKit .traj line -> 4x4 c2w (arkitscenes_dataparser.py:36-60):
    timestamp, rotation axis-angle (3), translation (3); stored as w2c."""
    vals = [float(v) for v in line.split()]
    rvec = np.asarray(vals[1:4])
    t = np.asarray(vals[4:7])
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = rvec / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    return np.linalg.inv(w2c)


class ARKitScenesDataParser(DataParser):
    """ARKitScenes lowres_wide export (arkitscenes_dataparser.py:95-227):
    frames keyed by timestamp, per-frame pincam intrinsics, .traj pose file
    (nearest-timestamp fallback), ARKit->nerfstudio flip."""

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data = Path(cfg.data)
        video_id = data.name
        image_dir = data / f"{video_id}_frames" / "lowres_wide"
        depth_dir = data / f"{video_id}_frames" / "lowres_depth"
        intr_dir = data / f"{video_id}_frames" / "lowres_wide_intrinsics"
        pose_file = data / f"{video_id}_frames" / "lowres_wide.traj"

        frame_ids = sorted(
            x.name.split(".png")[0].rsplit("_", 1)[1]
            for x in sorted(depth_dir.iterdir()))
        poses_from_traj = {}
        for line in open(pose_file, "r", encoding="utf-8"):
            ts = f"{round(float(line.split(' ')[0]), 3):.3f}"
            poses_from_traj[ts] = _traj_line_to_pose(line)

        def get_pose(fid):
            if fid in poses_from_traj:
                p = poses_from_traj[fid]
            else:  # nearest timestamp fallback (ref :204-216)
                keys = np.asarray([float(k) for k in poses_from_traj])
                near = keys[np.argmin(np.abs(keys - float(fid)))]
                p = poses_from_traj[f"{near:.3f}"]
            p = p.copy()
            p[0:3, 1:3] *= -1
            p = p[np.array([1, 0, 2, 3]), :]
            p[2, :] *= -1
            return p

        def get_intrinsic(fid):
            f = intr_dir / f"{video_id}_{fid}.pincam"
            if not f.exists():
                f = intr_dir / f"{video_id}_{float(fid) - 0.001:.3f}.pincam"
            if not f.exists():
                f = intr_dir / f"{video_id}_{float(fid) + 0.001:.3f}.pincam"
            w, h, fx, fy, hw, hh = np.loadtxt(f)
            K = np.array([[fx, 0, hw], [0, fy, hh], [0, 0, 1]], np.float32)
            return K, int(w), int(h)

        image_filenames, depth_filenames, Ks, poses = [], [], [], []
        w = h = None
        for fid in frame_ids:
            K, w, h = get_intrinsic(fid)
            Ks.append(K)
            poses.append(get_pose(fid))
            image_filenames.append(image_dir / f"{video_id}_{fid}.png")
            depth_filenames.append(depth_dir / f"{video_id}_{fid}.png")

        idx = _linspace_split(len(image_filenames),
                              cfg.train_split_fraction, split)
        poses = np.stack(poses).astype(np.float32)
        poses, transform = auto_orient_and_center_poses(
            poses, method="none", center_method=cfg.center_method)
        scale = 1.0
        if cfg.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale
        Ks = np.stack(Ks)

        cameras = CamerasHost(
            camera_to_worlds=poses[idx, :3, :4],
            fx=Ks[idx, 0, 0], fy=Ks[idx, 1, 1],
            cx=Ks[idx, 0, 2], cy=Ks[idx, 1, 2],
            width=np.full(len(idx), w, np.int32),
            height=np.full(len(idx), h, np.int32),
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube_box(cfg.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
            metadata={
                "depth_filenames": [depth_filenames[i] for i in idx],
                "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
            },
        )


@dataclasses.dataclass
class NuScenesDataParserConfig:
    data: Path = Path("scene-0103")          # scene NAME (ref convention)
    data_dir: Path = Path("/data/nuscenes")  # dataset root
    version: str = "v1.0-mini"
    cameras: tuple = ("FRONT",)
    mask_dir: Optional[Path] = None
    train_split_fraction: float = 0.9


class NuScenesDataParser(DataParser):
    """nuScenes surround-camera clips (nuscenes_dataparser.py:95-218).

    The reference reads them through the nuScenes devkit and
    pyquaternion; this parser joins the raw JSON tables (scene, sample,
    sample_data, calibrated_sensor, ego_pose, sensor) itself: the same
    poses without the SDK.
    """

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        root = Path(cfg.data_dir)
        tdir = root / cfg.version
        tables = {name: _load_json(tdir / f"{name}.json")
                  for name in ("scene", "sample", "sample_data",
                               "calibrated_sensor", "ego_pose", "sensor")}
        by_token = {name: {r["token"]: r for r in rows}
                    for name, rows in tables.items()}

        scene = next(s for s in tables["scene"]
                     if s["name"] == str(cfg.data))
        samples = [s for s in tables["sample"]
                   if s["scene_token"] == scene["token"]]
        samples.sort(key=lambda s: s["timestamp"])
        sample_tokens = {s["token"]: i for i, s in enumerate(samples)}

        cam_names = ["CAM_" + c for c in cfg.cameras]
        # key-frame sample_data per (sample, channel)
        sd_by_sample = {}
        for sd in tables["sample_data"]:
            if not sd["is_key_frame"]:
                continue
            if sd["sample_token"] not in sample_tokens:
                continue
            cs = by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
            channel = by_token["sensor"][cs["sensor_token"]]["channel"]
            if channel in cam_names:
                sd_by_sample[(sd["sample_token"], channel)] = sd

        transform1 = np.array(
            [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
            np.float64)
        transform2 = np.array(
            [[0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1]],
            np.float64)

        image_filenames, mask_filenames, intrinsics, poses = [], [], [], []
        for s in samples:
            for cam in cam_names:
                sd = sd_by_sample.get((s["token"], cam))
                if sd is None:
                    continue
                cs = by_token["calibrated_sensor"][
                    sd["calibrated_sensor_token"]]
                ego = by_token["ego_pose"][sd["ego_pose_token"]]
                ego_pose = np.eye(4)
                ego_pose[:3, :3] = _quat_wxyz_to_rotmat(ego["rotation"])
                ego_pose[:3, 3] = ego["translation"]
                cam_pose = np.eye(4)
                cam_pose[:3, :3] = _quat_wxyz_to_rotmat(cs["rotation"])
                cam_pose[:3, 3] = cs["translation"]
                pose = ego_pose @ cam_pose
                pose = transform1 @ pose
                pose[0:3, 1:3] *= -1
                pose = pose[np.array([1, 0, 2, 3]), :]
                pose[2, :] *= -1
                pose = transform2 @ pose
                image_filenames.append(root / sd["filename"])
                if cfg.mask_dir is not None:
                    mask_filenames.append(
                        Path(cfg.mask_dir) / "masks" / cam /
                        Path(sd["filename"]).name.replace("jpg", "png"))
                intrinsics.append(np.asarray(cs["camera_intrinsic"],
                                             np.float32))
                poses.append(pose)

        poses = np.stack(poses).astype(np.float32)
        intrinsics = np.stack(intrinsics)
        poses[:, :3, 3] -= poses[:, :3, 3].mean(axis=0)
        poses[:, :3, 3] /= np.abs(poses[:, :3, 3]).max() or 1.0

        n_snap = len(samples)
        i_snap = _linspace_split(n_snap, cfg.train_split_fraction, split)
        nc = len(cam_names)
        idx = (i_snap[None, :] * nc + np.arange(nc)[:, None]).ravel()
        idx = idx[idx < len(image_filenames)]

        w, h = _image_size(image_filenames[0])
        cameras = CamerasHost(
            camera_to_worlds=poses[idx, :3, :4],
            fx=intrinsics[idx, 0, 0], fy=intrinsics[idx, 1, 1],
            cx=intrinsics[idx, 0, 2], cy=intrinsics[idx, 1, 2],
            width=np.full(len(idx), w, np.int32),
            height=np.full(len(idx), h, np.int32),
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube_box(1.0),
            mask_filenames=([mask_filenames[i] for i in idx]
                            if mask_filenames else None),
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
