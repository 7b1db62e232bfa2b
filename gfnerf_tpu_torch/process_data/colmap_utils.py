"""COLMAP model reading and conversion to ``transforms.json``.

Copy of ``gfnerf_tpu/process_data/colmap_utils.py`` (nerfstudio's
``process_data/colmap_utils.py``), numpy and ``struct`` only: the readers
of COLMAP's ``cameras.bin/txt`` and ``images.bin/txt`` (the formats of
COLMAP's ``read_write_model``), ``qvec2rotmat``, and ``colmap_to_json``,
which writes the nerfstudio ``transforms.json`` the dataparsers read, with
the OpenCV -> OpenGL pose conversion.  The Phototourism parser reads the
binary model through it.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import numpy as np

# COLMAP camera models: id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def read_cameras_bin(path: Path) -> Dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            cams[cid] = {"model": name, "width": w, "height": h,
                         "params": list(params)}
    return cams


def read_images_bin(path: Path) -> Dict[int, dict]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            cid = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * npts, 1)
            images[iid] = {"qvec": np.array(qvec), "tvec": np.array(tvec),
                           "camera_id": cid, "name": name.decode()}
    return images


def read_cameras_txt(path: Path) -> Dict[int, dict]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = {
            "model": parts[1], "width": int(parts[2]),
            "height": int(parts[3]),
            "params": [float(x) for x in parts[4:]],
        }
    return cams


def read_images_txt(path: Path) -> Dict[int, dict]:
    images = {}
    lines = [ln for ln in Path(path).read_text().splitlines()
             if not ln.startswith("#")]
    for i in range(0, len(lines) - 1, 2):
        parts = lines[i].split()
        if len(parts) < 10:
            continue
        images[int(parts[0])] = {
            "qvec": np.array([float(x) for x in parts[1:5]]),
            "tvec": np.array([float(x) for x in parts[5:8]]),
            "camera_id": int(parts[8]), "name": parts[9],
        }
    return images


def _intrinsics(cam: dict) -> dict:
    model, p = cam["model"], cam["params"]
    out = {"w": cam["width"], "h": cam["height"],
           "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0, "p1": 0.0, "p2": 0.0}
    if model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif model in ("OPENCV", "OPENCV_FISHEYE"):
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5])
        if model == "OPENCV":
            out.update(p1=p[6], p2=p[7])
        else:
            out.update(k3=p[6], k4=p[7])
    else:
        raise ValueError(f"unsupported COLMAP model {model}")
    out["camera_model"] = ("OPENCV_FISHEYE" if "FISHEYE" in model
                           else "OPENCV")
    return out


def colmap_to_json(recon_dir: Path, output_dir: Path,
                   image_dir_name: str = "images") -> int:
    """COLMAP sparse model -> transforms.json (colmap_utils.colmap_to_json).

    Returns the number of registered frames.
    """
    recon_dir = Path(recon_dir)
    output_dir = Path(output_dir)
    if (recon_dir / "cameras.bin").exists():
        cams = read_cameras_bin(recon_dir / "cameras.bin")
        images = read_images_bin(recon_dir / "images.bin")
    else:
        cams = read_cameras_txt(recon_dir / "cameras.txt")
        images = read_images_txt(recon_dir / "images.txt")

    frames = []
    for iid, im in sorted(images.items()):
        rot = qvec2rotmat(im["qvec"])
        t = im["tvec"].reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([rot, t], 1), [[0, 0, 0, 1]]], 0)
        c2w = np.linalg.inv(w2c)
        # OpenCV -> OpenGL camera, gravity-up world (nerfstudio convention)
        c2w[0:3, 1:3] *= -1
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1
        frame = {
            "file_path": f"{image_dir_name}/{im['name']}",
            "transform_matrix": c2w.tolist(),
            **_intrinsics(cams[im["camera_id"]]),
        }
        frames.append(frame)

    out = {"camera_model": frames[0]["camera_model"] if frames else "OPENCV",
           "frames": frames}
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    return len(frames)
