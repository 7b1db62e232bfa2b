"""Capture-format converters -> nerfstudio ``transforms.json``.

Port of ``gfnerf_tpu/process_data/converters.py``: numpy, JSON, XML and CSV
reimplementations of the reference's ``nerfstudio/process_data/
{polycam,record3d,metashape,realitycapture,insta360,hloc}_utils`` (each
cited per function), with the same output files.  Where the JAX package
reads images with ``cv2`` or PIL, the port reads sizes from the files'
headers (``utils/image_io.image_size``) and pixels with ``read_image``
(a PNG by the port's decoder, a JPEG by its codec), and writes PNGs with
``write_png``: a JPEG the codec refuses (CMYK, arithmetic coding) raises
and names the file.  Video is decoded by the
``ffmpeg`` program when it is on ``PATH``; without it the video paths
raise.  hloc runs when its package is installed and raises with
instructions otherwise.
"""

from __future__ import annotations

import csv
import json
import shutil
import subprocess
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gfnerf_tpu_torch.utils.image_io import (image_size, read_image,
                                             write_png)


def _write_transforms(output_dir: Path, data: dict):
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4)


# ------------------------------------------------------------------ polycam ----


def polycam_to_json(image_filenames: List[Path], cameras_dir: Path,
                    output_dir: Path, min_blur_score: float = 25.0,
                    crop_border_pixels: int = 15,
                    depth_filenames: Optional[List[Path]] = None) -> List[str]:
    """Polycam per-frame camera JSONs -> transforms.json
    (polycam_utils.py:28-96): blur-score filtering, border crop applied to
    intrinsics, and the polycam->nerfstudio axis permutation (rows t_2, t_0,
    t_1 of the stored matrix)."""
    frames = []
    skipped = 0
    for i, image_filename in enumerate(image_filenames):
        j = json.loads(
            (Path(cameras_dir) / f"{image_filename.stem}.json").read_text())
        if "blur_score" in j and j["blur_score"] < min_blur_score:
            skipped += 1
            continue
        frame = {
            "fl_x": j["fx"], "fl_y": j["fy"],
            "cx": j["cx"] - crop_border_pixels,
            "cy": j["cy"] - crop_border_pixels,
            "w": j["width"] - crop_border_pixels * 2,
            "h": j["height"] - crop_border_pixels * 2,
            "file_path": f"./images/frame_{i+1:05d}{image_filename.suffix}",
            "transform_matrix": [
                [j["t_20"], j["t_21"], j["t_22"], j["t_23"]],
                [j["t_00"], j["t_01"], j["t_02"], j["t_03"]],
                [j["t_10"], j["t_11"], j["t_12"], j["t_13"]],
                [0.0, 0.0, 0.0, 1.0],
            ],
        }
        if depth_filenames:
            frame["depth_file_path"] = (
                f"./depth/frame_{i+1:05d}{depth_filenames[i].suffix}")
        frames.append(frame)
    if not frames:
        raise RuntimeError("no polycam frames survived blur filtering")
    _write_transforms(output_dir, {"camera_model": "OPENCV",
                                   "frames": frames})
    out = [f"Final dataset is {len(frames)} frames."]
    if skipped:
        out.insert(0, f"Skipped {skipped} frames due to low blur score.")
    return out


# ----------------------------------------------------------------- record3d ----


def _quat_xyzw_to_rotmat(q):
    x, y, z, w = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5 or 1.0
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def record3d_to_json(images_paths: List[Path], metadata_path: Path,
                     output_dir: Path, indices: np.ndarray) -> int:
    """Record3D metadata.json -> transforms.json (record3d_utils.py:28-93):
    scalar-last quaternion poses, column-major K, centered principal
    point."""
    meta = json.loads(Path(metadata_path).read_text())
    poses = np.asarray(meta["poses"])              # (N, 7) quat xyzw + t
    indices = np.asarray(indices)
    assert len(images_paths) == len(indices)
    frames = []
    for im_path, idx in zip(images_paths, indices):
        p = poses[idx]
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_xyzw_to_rotmat(p[:4])
        c2w[:3, 3] = p[4:7]
        frames.append({"file_path": Path(im_path).as_posix(),
                       "transform_matrix": c2w.tolist()})
    K = np.asarray(meta["K"]).reshape(3, 3).T      # stored column-major
    H, W = meta["h"], meta["w"]
    _write_transforms(output_dir, {
        "fl_x": float(K[0, 0]), "fl_y": float(K[0, 0]),
        "cx": W / 2.0, "cy": H / 2.0, "w": W, "h": H,
        "camera_model": "OPENCV", "frames": frames,
    })
    return len(frames)


# ---------------------------------------------------------------- metashape ----


def _has_children(el) -> bool:
    """An element's truth value in ElementTree: present, with children."""
    return el is not None and len(el) > 0


def metashape_to_json(image_filename_map: Dict[str, Path],
                      xml_filename: Path, output_dir: Path) -> List[str]:
    """Metashape cameras.xml -> transforms.json (metashape_utils.py:36-200):
    per-sensor intrinsics (f, cx/cy offsets from center, k1..k4/p1/p2),
    optional chunk-component transforms, and the metashape->nerfstudio axis
    permutation (rows [2,0,1] with y/z negation)."""
    root = ET.parse(str(xml_filename)).getroot()
    chunk = root[0]
    sensors = chunk.find("sensors")
    if sensors is None:
        raise ValueError("No sensors found")
    calibrated = [s for s in sensors
                  if s.get("type") == "spherical"
                  or _has_children(s.find("calibration"))]
    if not calibrated:
        raise ValueError("No calibrated sensor found in Metashape XML")
    stypes = [s.get("type") for s in calibrated]
    if stypes.count(stypes[0]) != len(stypes):
        raise ValueError("mixed Metashape sensor types are unsupported")
    model = {"frame": "OPENCV", "fisheye": "OPENCV_FISHEYE",
             "spherical": "EQUIRECTANGULAR"}.get(stypes[0])
    if model is None:
        raise ValueError(f"unsupported Metashape sensor type {stypes[0]!r}")

    def find_param(calib, name):
        el = calib.find(name)
        return float(el.text) if el is not None else 0.0

    sensor_dict = {}
    for sensor in calibrated:
        res = sensor.find("resolution")
        s = {"w": int(res.get("width")), "h": int(res.get("height"))}
        calib = sensor.find("calibration")
        if calib is None:
            s["fl_x"] = s["w"] / 2.0
            s["fl_y"] = s["h"]
            s["cx"] = s["w"] / 2.0
            s["cy"] = s["h"] / 2.0
        else:
            f = calib.find("f")
            assert f is not None, "no focal length in Metashape xml"
            s["fl_x"] = s["fl_y"] = float(f.text)
            s["cx"] = find_param(calib, "cx") + s["w"] / 2.0
            s["cy"] = find_param(calib, "cy") + s["h"] / 2.0
            for k in ("k1", "k2", "k3", "k4", "p1", "p2"):
                s[k] = find_param(calib, k)
        sensor_dict[sensor.get("id")] = s

    component_dict = {}
    components = chunk.find("components")
    if components is not None:
        for comp in components:
            tr = comp.find("transform")
            if tr is None:
                continue
            rot = tr.find("rotation")
            r = (np.asarray([float(x) for x in rot.text.split()]).reshape(3, 3)
                 if rot is not None else np.eye(3))
            trans = tr.find("translation")
            t = (np.asarray([float(x) for x in trans.text.split()])
                 if trans is not None else np.zeros(3))
            sc = tr.find("scale")
            scale = float(sc.text) if sc is not None else 1.0
            m = np.eye(4)
            m[:3, :3] = r
            m[:3, 3] = t / scale
            component_dict[comp.get("id")] = m

    frames, skipped = [], 0
    cameras = chunk.find("cameras")
    assert cameras is not None, "no cameras in Metashape xml"
    for camera in cameras:
        label = camera.get("label")
        if label not in image_filename_map:
            label = label.split(".")[0]
            if label not in image_filename_map:
                continue
        sensor_id = camera.get("sensor_id")
        if sensor_id not in sensor_dict or camera.find("transform") is None:
            skipped += 1
            continue
        frame = {"file_path": image_filename_map[label].as_posix()}
        frame.update(sensor_dict[sensor_id])
        t = np.asarray([float(x) for x in
                        camera.find("transform").text.split()]).reshape(4, 4)
        cid = camera.get("component_id")
        if cid in component_dict:
            t = component_dict[cid] @ t
        t = t[[2, 0, 1, 3], :]
        t[:, 1:3] *= -1
        frame["transform_matrix"] = t.tolist()
        frames.append(frame)

    _write_transforms(output_dir, {"camera_model": model, "frames": frames})
    out = [f"Final dataset is {len(frames)} frames."]
    if skipped:
        out.insert(0, f"{skipped} images skipped (missing pose/calibration).")
    return out


# ------------------------------------------------------------ realitycapture ----


def _rc_rotation(yaw, pitch, roll):
    # realitycapture_utils.py:110-127 (z @ x @ y euler composition, degrees)
    sy, cy = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
    sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
    sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
    rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    rot_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rot_z @ rot_x @ rot_y


def realitycapture_to_json(image_filename_map: Dict[str, Path],
                           csv_filename: Path, output_dir: Path,
                           image_sizes: Optional[Dict[str, tuple]] = None
                           ) -> List[str]:
    """RealityCapture CSV export -> transforms.json
    (realitycapture_utils.py:45-107): 35mm-equivalent focal scaling,
    principal-point offsets, heading/pitch/roll euler poses.

    ``image_sizes``: optional {basename: (w, h)}; a size it lacks comes
    from the image's header (``image_io.image_size``, PNG or JPEG).
    """
    with open(csv_filename, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    frames, missing = [], 0
    for row in rows:
        basename = row["#name"].rpartition(".")[0]
        if basename not in image_filename_map:
            missing += 1
            continue
        if image_sizes and basename in image_sizes:
            w, h = image_sizes[basename]
        else:
            w, h = image_size(Path(output_dir)
                              / image_filename_map[basename])
        frame = {
            "file_path": image_filename_map[basename].as_posix(),
            "w": int(w), "h": int(h),
            "fl_x": float(row["f"]) * max(w, h) / 36,
            "fl_y": float(row["f"]) * max(w, h) / 36,
            "cx": float(row["px"]) / 36.0 + w / 2.0,
            "cy": float(row["py"]) / 36.0 + h / 2.0,
            "k1": row["k1"], "k2": row["k2"], "k3": row["k3"],
            "k4": row["k4"], "p1": row["t1"], "p2": row["t2"],
        }
        t = np.eye(4)
        t[:3, :3] = _rc_rotation(-float(row["heading"]),
                                 float(row["pitch"]), float(row["roll"]))
        t[:3, 3] = [float(row["x"]), float(row["y"]), float(row["alt"])]
        frame["transform_matrix"] = t.tolist()
        frames.append(frame)
    _write_transforms(output_dir, {"camera_model": "OPENCV",
                                   "orientation_override": "none",
                                   "frames": frames})
    out = [f"Final dataset is {len(frames)} frames."]
    if missing:
        out.insert(0, f"Missing image data for {missing} cameras.")
    return out


# ------------------------------------------------------------------ insta360 ----
#
# The reference's insta360 path (insta360_utils.py:54-194) is frame
# extraction and per-lens cropping, written there as ffmpeg filter graphs.
# The geometry itself (uniform frame selection, ``thumbnail=N``; the 70%
# centre crop that removes the curved fisheye border; the transpose=2 /
# transpose=1 lens rotations; the front-then-back ``frame_%05d.png``
# numbering) is array work, done here in numpy; video decode needs ffmpeg.


def _load_image(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of an image file (``read_image``: a PNG
    or a JPEG on every device): grey repeated, alpha dropped, 16-bit
    samples reduced to their high byte.  A file the decoder refuses raises
    and names it."""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _save_image(path: Path, arr: np.ndarray):
    write_png(path, np.ascontiguousarray(arr))


def _select_frames(frames: List[Path], num_target: int) -> List[Path]:
    """ffmpeg ``thumbnail=spacing``: every spacing-th frame
    (insta360_utils.py:93-97); spacing <= 1 keeps every frame (the
    reference logs "Can't satisfy requested number of frames")."""
    spacing = len(frames) // max(num_target, 1)
    if spacing > 1:
        return frames[::spacing]
    return list(frames)


def insta360_frames_to_images(
    front_frames: List[Path], back_frames: List[Path], image_dir: Path,
    num_frames_target: int, crop_percentage: float = 0.7,
) -> List[str]:
    """Two-file insta360 capture (front and back fisheye frame sequences)
    -> one ``frame_%05d.png`` sequence, as ``convert_insta360_to_images``
    (insta360_utils.py:54-124): num_frames_target // 2 frames a lens,
    evenly spaced; each cropped to ``crop_percentage`` of its sides about
    the centre; the front turned 90 degrees counter-clockwise
    (``transpose=2``) and the back clockwise (``transpose=1``); the back
    numbered after the front."""
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    for img in image_dir.glob("*.png"):
        img.unlink()

    def crop_center(a: np.ndarray) -> np.ndarray:
        h, w = a.shape[:2]
        ch, cw = int(h * crop_percentage), int(w * crop_percentage)
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        return a[y0:y0 + ch, x0:x0 + cw]

    idx = 0
    per_lens = max(num_frames_target // 2, 1)
    for frames, k_rot in ((_select_frames(front_frames, per_lens), 1),
                          (_select_frames(back_frames, per_lens), -1)):
        for p in frames:
            arr = np.rot90(crop_center(_load_image(Path(p))), k=k_rot)
            idx += 1
            _save_image(image_dir / f"frame_{idx:05d}.png", arr)
    return [f"Starting with {len(front_frames) + len(back_frames)} video "
            f"frames", f"We extracted {idx} images"]


def insta360_single_frames_to_images(
    frames: List[Path], image_dir: Path, num_frames_target: int,
    crop_percentage: float = 0.7,
) -> List[str]:
    """Single-file insta360 capture (both fisheyes side by side in each
    frame) -> ``frame_%05d.png``, as
    ``convert_insta360_single_file_to_images`` (insta360_utils.py:127-194):
    the front lens the ih*p square at x = iw/2 + ih*p/4, the back lens the
    one at x = ih*p/4, both at y = ih*p/4; no rotation; the front frames
    first."""
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    for img in image_dir.glob("*.png"):
        img.unlink()

    selected = _select_frames(frames, max(num_frames_target // 2, 1))
    idx = 0
    for off_front in (True, False):
        for p in selected:
            arr = _load_image(Path(p))
            h, w = arr.shape[:2]
            s = int(h * crop_percentage)
            y0 = int(h * crop_percentage / 4)
            x0 = (w // 2 + y0) if off_front else y0
            idx += 1
            _save_image(image_dir / f"frame_{idx:05d}.png",
                        arr[y0:y0 + s, x0:x0 + s])
    return [f"Starting with {len(frames)} video frames",
            f"We extracted {idx} images"]


def decode_video_frames(video: Path, out_dir: Path) -> List[Path]:
    """Every frame of a video as ``out_dir/f_%05d.png`` (from 1), decoded
    by ffmpeg, one PNG a frame; raises without ffmpeg on ``PATH`` or when
    the video has no frame."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "video decode needs the ffmpeg program, which is not on PATH; "
            "photo-mode or decoded captures work through "
            "insta360_frames_to_images / insta360_single_frames_to_images.")
    proc = subprocess.run([ffmpeg, "-nostdin", "-loglevel", "error", "-i",
                           str(video), "-vsync", "0",
                           str(out_dir / "f_%05d.png")],
                          capture_output=True, text=True)
    frames = sorted(out_dir.glob("f_*.png"))
    if proc.returncode != 0 or not frames:
        raise RuntimeError(f"ffmpeg decoded no frames of {video}: "
                           f"{proc.stderr.strip()[-2000:]}")
    return frames


def insta360_to_images(video_front: Path, video_back: Optional[Path],
                       image_dir: Path, num_frames_target: int,
                       crop_percentage: float = 0.7) -> List[str]:
    """Video entry point: decode with ffmpeg, then the frame pipeline
    above (two videos: front and back; one: both lenses side by side)."""
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        outs = []
        for name, video in (("front", video_front), ("back", video_back)):
            if video is None:
                continue
            outs.append(decode_video_frames(Path(video), td / name))
        if len(outs) == 2:
            return insta360_frames_to_images(
                outs[0], outs[1], image_dir, num_frames_target,
                crop_percentage)
        return insta360_single_frames_to_images(
            outs[0], image_dir, num_frames_target, crop_percentage)


# ---------------------------------------------------------------------- hloc ----


def hloc_to_json(image_dir: Path, output_dir: Path,
                 matching_method: str = "vocab_tree",
                 feature_type: str = "superpoint_aachen",
                 matcher_type: str = "superglue",
                 num_matched: int = 50) -> List[str]:
    """SfM through the hloc toolbox (reference hloc_utils.py:52-141):
    NetVLAD retrieval (or exhaustive pairs), SuperPoint features,
    SuperGlue matches, a pycolmap reconstruction; then the COLMAP model
    goes through ``colmap_utils.colmap_to_json``.  Without the hloc
    package this raises with install instructions."""
    try:
        from hloc import (  # type: ignore
            extract_features,
            match_features,
            pairs_from_exhaustive,
            pairs_from_retrieval,
            reconstruction,
        )
    except ImportError as e:
        raise RuntimeError(
            "hloc is not available in this environment; use the COLMAP "
            "path (python -m gfnerf_tpu_torch.process_data images-colmap) "
            "or install github.com/cvg/Hierarchical-Localization and "
            "re-run.") from e

    image_dir, output_dir = Path(image_dir), Path(output_dir)
    outputs = output_dir / "hloc"
    outputs.mkdir(parents=True, exist_ok=True)
    sfm_pairs = outputs / "pairs-netvlad.txt"
    sfm_dir = outputs / "sparse"
    features = outputs / "features.h5"
    matches = outputs / "matches.h5"
    references = [p.relative_to(image_dir).as_posix()
                  for p in sorted(image_dir.iterdir()) if p.is_file()]

    feature_conf = extract_features.confs[feature_type]
    matcher_conf = match_features.confs[matcher_type]
    extract_features.main(feature_conf, image_dir, image_list=references,
                          feature_path=features)
    if matching_method == "exhaustive":
        pairs_from_exhaustive.main(sfm_pairs, image_list=references)
    else:
        retrieval_path = extract_features.main(
            extract_features.confs["netvlad"], image_dir, outputs)
        pairs_from_retrieval.main(retrieval_path, sfm_pairs,
                                  num_matched=min(num_matched,
                                                  len(references)))
    match_features.main(matcher_conf, sfm_pairs, features=features,
                        matches=matches)
    reconstruction.main(sfm_dir, image_dir, sfm_pairs, features, matches,
                        image_list=references)

    from gfnerf_tpu_torch.process_data.colmap_utils import colmap_to_json

    n = colmap_to_json(sfm_dir, output_dir)
    return [f"hloc reconstruction with {len(references)} images",
            f"Colmap matched {n} images"]
