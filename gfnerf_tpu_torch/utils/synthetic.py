"""Synthetic test scenes (analytic renders, no assets needed).

Numpy copies of ``gfnerf_tpu/utils/synthetic.py``'s ``ring_cameras``,
``render_spheres``, ``make_synthetic_npz`` and ``make_blender_fixture``:
ring cameras around coloured spheres, images rendered by direct
ray-sphere intersection with Lambert shading, written as the minimal
dataparser's npz files or as a Blender-layout scene of PNGs (through
``image_io.write_png``; optionally RGBA with the spheres' coverage as
alpha, a transparent sky as in the published Blender scenes).
``make_dnerf_fixture`` writes a dynamic scene in the D-NeRF layout: a
sphere whose centre moves with the frame's time, beside two still ones.

The capture writers put the ring scene in the layouts of the remaining
parsers (``CAPTURE_FIXTURES``): ScanNet, SDFStudio, Phototourism (COLMAP's
binary model, written with ``struct``), Sitcoms3D, ARKitScenes and
nuScenes, each with its own camera convention, with PNG images (named
``.png`` where the format lets a name be chosen) and, where the format
has them, depth maps, normals and masks rendered from the same spheres.
Each parser turns the poses back into the ring's, up to the similarity
transform it applies itself (centring, orientation, scale).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.utils.image_io import write_png

SPHERES = np.array([
    # x, y, z, radius, r, g, b
    [0.0, 0.0, 0.0, 0.9, 0.9, 0.2, 0.2],
    [1.2, 0.6, -0.2, 0.45, 0.2, 0.8, 0.3],
    [-1.0, -0.7, 0.3, 0.55, 0.2, 0.4, 0.9],
], dtype=np.float32)


def ring_cameras(n: int = 24, radius: float = 4.0, height: float = 1.2,
                 img_wh=(64, 48), focal: float = 55.0):
    c2ws = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        forward = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, forward)
        rot = np.stack([right, true_up, -forward], axis=-1)  # z backward
        c2ws.append(np.concatenate([rot, pos[:, None]], axis=-1))
    c2w = np.stack(c2ws).astype(np.float32)
    w, h = img_wh
    fx = np.full(n, focal, np.float32)
    fy = np.full(n, focal, np.float32)
    cx = np.full(n, w / 2.0, np.float32)
    cy = np.full(n, h / 2.0, np.float32)
    return c2w, fx, fy, cx, cy, w, h


def render_spheres(c2w, fx, fy, cx, cy, w, h,
                   spheres: np.ndarray = SPHERES,
                   coverage: bool = False, geometry: bool = False):
    """Analytic render: nearest sphere hit, Lambert-shaded. (N, H, W, 3);
    with ``coverage``, (N, H, W, 4): the fourth channel 1 where a ray hits
    a sphere, 0 on the sky.  With ``geometry``, (images, depth, normals):
    the hit's depth along the camera's viewing axis (N, H, W), 0 on the
    sky, and the unit surface normal in the camera's frame (x right, y up,
    z backward) (N, H, W, 3), 0 on the sky."""
    n = len(c2w)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    imgs = np.zeros((n, h, w, 4 if coverage else 3), np.float32)
    depths = np.zeros((n, h, w), np.float32)
    normals = np.zeros((n, h, w, 3), np.float32)
    light = np.array([0.4, 0.3, 0.85])
    light = light / np.linalg.norm(light)
    for i in range(n):
        d_cam = np.stack([(xx - cx[i]) / fx[i], -(yy - cy[i]) / fy[i],
                          -np.ones_like(xx)], axis=-1)
        d = d_cam @ c2w[i, :3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[i, :3, 3]
        best_t = np.full((h, w), np.inf, np.float32)
        best_n = np.zeros((h, w, 3))
        # sky-gradient background: an all-black background makes "predict
        # black everywhere" a gradient-dead attractor (sigmoid saturates to
        # exactly 0 and every gradient vanishes) — real captures are never
        # black, so neither are the fixtures
        sky_t = np.clip(d[..., 2] * 0.5 + 0.5, 0, 1)
        img = np.stack([0.35 + 0.25 * sky_t, 0.45 + 0.25 * sky_t,
                        0.55 + 0.35 * sky_t], axis=-1).astype(np.float32)
        for sx, sy, sz, r, cr, cg, cb in spheres:
            ctr = np.array([sx, sy, sz])
            oc = o - ctr
            b = np.einsum("hwc,c->hw", d, oc)
            c = float(oc @ oc - r * r)
            disc = b * b - c
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit &= (t > 0) & (t < best_t)
            p = o + t[..., None] * d
            nrm = (p - ctr) / r
            lam = np.clip(np.einsum("hwc,c->hw", nrm, light), 0.1, 1.0)
            col = np.stack([cr * lam, cg * lam, cb * lam], axis=-1)
            img = np.where(hit[..., None], col, img)
            best_t = np.where(hit, t, best_t)
            best_n = np.where(hit[..., None], nrm, best_n)
        imgs[i, ..., :3] = img
        if coverage:
            imgs[i, ..., 3] = np.isfinite(best_t)
        if geometry:
            hit = np.isfinite(best_t)
            # the viewing axis is the camera's -z
            depth = best_t * (d @ -c2w[i, :3, 2])
            depths[i] = np.where(hit, depth, 0.0)
            normals[i] = best_n @ c2w[i, :3, :3]
    if geometry:
        return imgs, depths, normals
    return imgs


def make_synthetic_npz(path: Path, n_train: int = 24, n_val: int = 3,
                       img_wh=(64, 48), seed: int = 0) -> Path:
    """Write train.npz / val.npz consumable by the minimal dataparser: the
    ring scene's views, ``n_val`` of them drawn as the validation split."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    total = n_train + n_val
    c2w, fx, fy, cx, cy, w, h = ring_cameras(total, img_wh=img_wh)
    imgs = render_spheres(c2w, fx, fy, cx, cy, w, h)
    rng = np.random.default_rng(seed)
    val_idx = rng.choice(total, n_val, replace=False)
    train_idx = np.setdiff1d(np.arange(total), val_idx)

    def save(split, idx):
        np.savez(
            path / f"{split}.npz",
            images=(imgs[idx] * 255).astype(np.uint8),
            c2w=c2w[idx], fx=fx[idx], fy=fy[idx], cx=cx[idx], cy=cy[idx],
            bounds=np.tile(np.array([[0.05, 20.0]], np.float32),
                           (len(idx), 1)),
        )

    save("train", train_idx)
    save("val", val_idx)
    return path


def make_blender_fixture(path: Path, n_train: int = 10, n_eval: int = 2,
                         img_wh=(40, 30), rgba: bool = False,
                         focal: float = 55.0) -> Path:
    """Write a Blender-format dataset (transforms_{split}.json and PNGs)
    from the synthetic renderer: train, val and test (the same views as
    val).  ``rgba``: RGBA PNGs whose alpha is the spheres' coverage (the
    sky transparent, as in the published Blender scenes); else RGB with
    the sky drawn, as the JAX package writes them."""
    path = Path(path)
    total = n_train + n_eval
    c2w, fx, fy, cx, cy, w, h = ring_cameras(total, img_wh=img_wh,
                                             focal=focal)
    imgs = render_spheres(c2w, fx, fy, cx, cy, w, h, coverage=rgba)
    cam_angle_x = 2 * np.arctan(w / (2 * fx[0]))
    splits = (("train", 0, n_train), ("val", n_train, total),
              ("test", n_train, total))
    for split, lo, hi in splits:
        (path / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(lo, hi):
            m = np.eye(4)
            m[:3, :4] = c2w[i]
            write_png(path / split / f"r_{i}.png",
                      (imgs[i] * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": m.tolist()})
        (path / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": float(cam_angle_x), "frames": frames}))
    return path


def moving_spheres(t: float) -> np.ndarray:
    """The dynamic scene at time ``t`` in [0, 1]: SPHERES' two small ones
    still, the large one shrunk to radius 0.6 and moved half a turn round
    the z axis on a circle of radius 0.7, rising by 0.3."""
    out = SPHERES.copy()
    ang = np.pi * t
    out[0, :4] = [0.7 * np.cos(ang), 0.7 * np.sin(ang), 0.3 * t - 0.15, 0.6]
    return out


def make_dnerf_fixture(path: Path, n_train: int = 24, n_val: int = 4,
                       img_wh=(200, 200), focal: float = 180.0,
                       n_times: int = 4) -> Path:
    """Write a D-NeRF-layout dataset (transforms_{train,val,test}.json with
    a ``time`` a frame, RGBA PNGs with a transparent sky) of a scene seen
    at ``n_times`` times by several cameras each, as a multi-camera video
    capture: train view i on a ring of 2 n_train positions at position
    2i, at time (i mod n_times) / (n_times - 1), so each time's views are
    spread round the ring; val view j (test: the same) at the odd position
    between, 2 j n_train / n_val + 1, at time (j mod n_times) / (n_times -
    1), so that val view 0 shares train view 0's time 0."""
    path = Path(path)
    c2w, fx, fy, cx, cy, w, h = ring_cameras(2 * n_train, img_wh=img_wh,
                                             focal=focal)
    step = max(n_times - 1, 1)
    views = [(2 * i, (i % n_times) / step) for i in range(n_train)] + [
        (2 * (j * n_train // n_val) + 1, (j % n_times) / step)
        for j in range(n_val)]
    cam_angle_x = 2 * np.arctan(w / (2 * fx[0]))
    splits = (("train", 0, n_train), ("val", n_train, n_train + n_val),
              ("test", n_train, n_train + n_val))
    for split, lo, hi in splits:
        (path / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(lo, hi):
            v, t = views[i]
            img = render_spheres(c2w[v:v + 1], fx, fy, cx, cy, w, h,
                                 spheres=moving_spheres(t), coverage=True)[0]
            m = np.eye(4)
            m[:3, :4] = c2w[v]
            write_png(path / split / f"r_{i}.png",
                      (img * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": m.tolist(), "time": t})
        (path / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": float(cam_angle_x), "frames": frames}))
    return path


# ---- captures in the layouts of the remaining parsers ----


def _ring_scene(n: int, img_wh, focal: float, geometry: bool = False,
                sky: bool = True):
    """(cameras as ring_cameras gives them, 4x4 camera-to-worlds in the
    nerfstudio convention, uint8 images[, depth, normals]); without
    ``sky`` the spheres over black."""
    cams = ring_cameras(n, img_wh=img_wh, focal=focal)
    c2w = np.tile(np.eye(4), (n, 1, 1))
    c2w[:, :3, :4] = cams[0]
    out = render_spheres(*cams, coverage=not sky, geometry=geometry)
    imgs = out[0] if geometry else out
    if not sky:
        imgs = imgs[..., :3] * imgs[..., 3:]
    imgs = (np.clip(imgs, 0.0, 1.0) * 255).astype(np.uint8)
    return (cams, c2w, imgs, *out[1:]) if geometry else (cams, c2w, imgs)


def _to_opencv(c2w: np.ndarray) -> np.ndarray:
    """A camera-to-world with the camera's y and z axes flipped (nerfstudio
    <-> OpenCV): its own inverse."""
    out = np.array(c2w, np.float64)
    out[..., 0:3, 1:3] *= -1
    return out


def _from_nerfstudio_scannet(c2w: np.ndarray) -> np.ndarray:
    """The OpenCV camera-to-world that the ScanNet, ARKitScenes and
    nuScenes parsers turn into ``c2w`` (they flip the camera's y and z,
    swap the world's x and y, and negate its z)."""
    out = np.array(c2w, np.float64)
    out[2, :] *= -1
    out = out[np.array([1, 0, 2, 3]), :]
    return _to_opencv(out)


def rotmat2qvec(rot: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z) with w >= 0 of a rotation matrix
    (COLMAP's ``rotmat2qvec``; ``colmap_utils.qvec2rotmat`` inverts it)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(
        rot, np.float64).flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[np.array([3, 0, 1, 2]), np.argmax(vals)]
    return -q if q[0] < 0 else q


def _depth_png(depth: np.ndarray) -> np.ndarray:
    """Depth in metres as ScanNet's and ARKit's 16-bit millimetre PNGs."""
    return np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)


def make_scannet_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                         focal: float = 55.0) -> Path:
    """ScanNet's export: ``color/{i}.png``, 16-bit millimetre
    ``depth/{i}.png``, ``pose/{i}.txt`` (OpenCV camera-to-world in
    ScanNet's world) and ``intrinsic/intrinsic_color.txt`` (4x4)."""
    path = Path(path)
    cams, c2w4, imgs, depth, _ = _ring_scene(n, img_wh, focal, True)
    for sub in ("color", "depth", "pose", "intrinsic"):
        (path / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_png(path / "color" / f"{i}.png", imgs[i])
        write_png(path / "depth" / f"{i}.png", _depth_png(depth[i]))
        np.savetxt(path / "pose" / f"{i}.txt",
                   _from_nerfstudio_scannet(c2w4[i]))
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = (cams[1][0], cams[2][0],
                                          cams[3][0], cams[4][0])
    np.savetxt(path / "intrinsic" / "intrinsic_color.txt", k)
    return path


def make_sdfstudio_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                           focal: float = 55.0) -> Path:
    """SDFStudio's ``meta_data.json`` (4x4 intrinsics and OpenCV
    camera-to-worlds a frame, the scene box) with ``{i:06d}_rgb.png`` and
    each frame's depth and OpenCV-frame normals as ``.npy`` (the monocular
    priors' files)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cams, c2w4, imgs, depth, normals = _ring_scene(n, img_wh, focal, True)
    w, h = img_wh
    frames = []
    for i in range(n):
        write_png(path / f"{i:06d}_rgb.png", imgs[i])
        k = np.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = (cams[1][i], cams[2][i],
                                              cams[3][i], cams[4][i])
        np.save(path / f"{i:06d}_depth.npy", depth[i])
        np.save(path / f"{i:06d}_normal.npy",
                normals[i] * np.array([1, -1, -1], np.float32))
        frames.append({"rgb_path": f"{i:06d}_rgb.png",
                       "intrinsics": k.tolist(),
                       "camtoworld": _to_opencv(c2w4[i]).tolist(),
                       "mono_depth_path": f"{i:06d}_depth.npy",
                       "mono_normal_path": f"{i:06d}_normal.npy"})
    meta = {"frames": frames, "width": w, "height": h,
            "has_mono_prior": True,
            "scene_box": {"aabb": [[-2.0, -2.0, -1.5], [2.0, 2.0, 1.5]]}}
    (path / "meta_data.json").write_text(json.dumps(meta))
    return path


def write_colmap_model(sparse: Path, c2w: np.ndarray, fx, fy, cx, cy,
                       w: int, h: int, names) -> None:
    """COLMAP's binary ``cameras.bin`` and ``images.bin`` (no points): a
    PINHOLE camera and one image per view, camera and image ids 1..N, the
    world-to-camera poses of the nerfstudio camera-to-worlds ``c2w``
    (N, 4, 4) in COLMAP's OpenCV convention."""
    sparse = Path(sparse)
    sparse.mkdir(parents=True, exist_ok=True)
    n = len(c2w)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<iiQQ", i + 1, 1, w, h))   # 1: PINHOLE
            f.write(struct.pack("<4d", fx[i], fy[i], cx[i], cy[i]))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            w2c = np.linalg.inv(_to_opencv(c2w[i]))
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *rotmat2qvec(w2c[:3, :3])))
            f.write(struct.pack("<3d", *w2c[:3, 3]))
            f.write(struct.pack("<i", i + 1))
            f.write(names[i].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def make_phototourism_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                              focal: float = 55.0, sky: bool = True) -> Path:
    """A Phototourism capture: ``dense/images/im_{i}.png`` and COLMAP's
    binary model in ``dense/sparse`` (``write_colmap_model``); without
    ``sky`` the spheres over black."""
    path = Path(path)
    cams, c2w4, imgs = _ring_scene(n, img_wh, focal, sky=sky)
    names = [f"im_{i}.png" for i in range(n)]
    (path / "dense" / "images").mkdir(parents=True, exist_ok=True)
    for name, img in zip(names, imgs):
        write_png(path / "dense" / "images" / name, img)
    write_colmap_model(path / "dense" / "sparse", c2w4, *cams[1:5],
                       *img_wh, names)
    return path


# Sitcoms3D's world turned to z up: the parser applies this to the files'
# poses and box
SITCOMS_ROT = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)


def make_sitcoms3d_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                           focal: float = 55.0) -> Path:
    """Sitcoms3D's ``cameras.json`` (full-size intrinsics, camera-to-worlds
    and a box in its y-up world) with the images at the parser's default
    quarter size in ``images_4/f{i}.png``,
    ``segmentations_4/thing/f{i}.png`` (class 1 on the spheres, 0
    elsewhere) and ``panoptic_classes.json``."""
    path = Path(path)
    cams, c2w4, imgs = _ring_scene(n, img_wh, focal)
    downscale = 4
    (path / "images_4").mkdir(parents=True, exist_ok=True)
    (path / "segmentations_4" / "thing").mkdir(parents=True, exist_ok=True)
    cover = render_spheres(*cams, coverage=True)[..., 3]
    frames = []
    for i in range(n):
        name = f"f{i}.png"
        write_png(path / "images_4" / name, imgs[i])
        write_png(path / "segmentations_4" / "thing" / name,
                  cover[i].astype(np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3] = SITCOMS_ROT.T @ c2w4[i, :3, :3]
        c2w[:3, 3] = SITCOMS_ROT.T @ c2w4[i, :3, 3]
        k = np.array([[cams[1][i], 0, cams[3][i]], [0, cams[2][i], cams[4][i]],
                      [0, 0, 1]]) * np.array([[downscale], [downscale], [1]])
        frames.append({"image_name": name, "intrinsics": k.tolist(),
                       "camtoworld": c2w.tolist()})
    box = np.array([[-2.0, -2.0, -1.5], [2.0, 2.0, 1.5]]) @ SITCOMS_ROT
    (path / "cameras.json").write_text(json.dumps(
        {"frames": frames, "bbox": box.tolist()}))
    (path / "panoptic_classes.json").write_text(json.dumps(
        {"thing": ["person", "sphere"],
         "thing_colors": [[220, 20, 60], [0, 160, 80]]}))
    return path


def _rotvec(rot: np.ndarray) -> np.ndarray:
    """The axis-angle vector of a rotation matrix (angle in [0, pi])."""
    w, *v = rotmat2qvec(rot)
    v = np.asarray(v)
    sin = np.linalg.norm(v)
    if sin < 1e-12:
        return np.zeros(3)
    return 2.0 * np.arctan2(sin, w) * v / sin


def make_arkitscenes_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                             focal: float = 55.0) -> Path:
    """ARKitScenes' ``lowres_wide`` export of video ``40753679`` under
    ``path/{video_id}``:
    ``{video_id}_{ts}.png`` images and 16-bit millimetre depth, a
    ``.pincam`` intrinsics file a frame and ``lowres_wide.traj`` (each
    frame's world-to-camera as a timestamp, an axis-angle rotation and a
    translation), frame i at timestamp 10 + 0.1 i.  Returns the video
    directory."""
    video_id = "40753679"
    path = Path(path) / video_id
    frames = path / f"{video_id}_frames"
    for sub in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        (frames / sub).mkdir(parents=True, exist_ok=True)
    cams, c2w4, imgs, depth, _ = _ring_scene(n, img_wh, focal, True)
    w, h = img_wh
    lines = []
    for i in range(n):
        ts = f"{10.0 + 0.1 * i:.3f}"
        write_png(frames / "lowres_wide" / f"{video_id}_{ts}.png", imgs[i])
        write_png(frames / "lowres_depth" / f"{video_id}_{ts}.png",
                  _depth_png(depth[i]))
        np.savetxt(frames / "lowres_wide_intrinsics" /
                   f"{video_id}_{ts}.pincam",
                   np.array([[w, h, cams[1][i], cams[2][i], cams[3][i],
                              cams[4][i]]]))
        w2c = np.linalg.inv(_from_nerfstudio_scannet(c2w4[i]))
        lines.append(" ".join([ts, *(repr(float(v)) for v in
                                     (*_rotvec(w2c[:3, :3]), *w2c[:3, 3]))]))
    (frames / "lowres_wide.traj").write_text("\n".join(lines) + "\n")
    return path


# nuScenes' camera and world conventions as its parser composes them:
# pose = NUSCENES_T2 @ flip(NUSCENES_T1 @ ego @ sensor)
NUSCENES_T1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                        [0, 0, 0, 1]], np.float64)
NUSCENES_T2 = np.array([[0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0],
                        [0, 0, 0, 1]], np.float64)
NUSCENES_SCENE = "scene-0001"


def make_nuscenes_fixture(path: Path, n: int = 12, img_wh=(64, 48),
                          focal: float = 55.0) -> Path:
    """A nuScenes clip ``NUSCENES_SCENE`` of ``n`` key frames from one
    front camera, as the raw JSON tables under ``path/v1.0-mini`` (each
    frame's pose in its ``ego_pose``, the camera's calibration the
    identity with the intrinsics), ``samples/CAM_FRONT/img_{i}.png`` and
    ``masks/CAM_FRONT/img_{i}.png`` (255 everywhere).
    Returns the dataset root (the parser's ``data_dir``; its ``data`` is
    the scene's name)."""
    path = Path(path)
    tables = path / "v1.0-mini"
    tables.mkdir(parents=True, exist_ok=True)
    cams, c2w4, imgs = _ring_scene(n, img_wh, focal)
    k = [[float(cams[1][0]), 0.0, float(cams[3][0])],
         [0.0, float(cams[2][0]), float(cams[4][0])], [0.0, 0.0, 1.0]]
    rows = {
        "scene": [{"token": "sc0", "name": NUSCENES_SCENE}],
        "sample": [{"token": f"sa{i}", "scene_token": "sc0",
                    "timestamp": 1000 * i} for i in range(n)],
        "sensor": [{"token": "se0", "channel": "CAM_FRONT"}],
        "calibrated_sensor": [{"token": "cs0", "sensor_token": "se0",
                               "rotation": [1.0, 0.0, 0.0, 0.0],
                               "translation": [0.0, 0.0, 0.0],
                               "camera_intrinsic": k}],
        "ego_pose": [], "sample_data": []}
    (path / "samples" / "CAM_FRONT").mkdir(parents=True, exist_ok=True)
    (path / "masks" / "CAM_FRONT").mkdir(parents=True, exist_ok=True)
    flip_rows = np.array([[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0],
                          [0, 0, 0, 1]], np.float64)
    for i in range(n):
        # undo T2, the flip (rows, then the camera's y and z), then T1
        pose = np.linalg.inv(NUSCENES_T2) @ c2w4[i]
        pose = _to_opencv(np.linalg.inv(flip_rows) @ pose)
        pose = np.linalg.inv(NUSCENES_T1) @ pose
        rows["ego_pose"].append({
            "token": f"ep{i}", "rotation": rotmat2qvec(pose[:3, :3]).tolist(),
            "translation": pose[:3, 3].tolist()})
        name = f"samples/CAM_FRONT/img_{i}.png"
        write_png(path / name, imgs[i])
        write_png(path / "masks" / "CAM_FRONT" / f"img_{i}.png",
                  np.full(imgs[i].shape[:2], 255, np.uint8))
        rows["sample_data"].append({
            "token": f"sd{i}", "sample_token": f"sa{i}",
            "calibrated_sensor_token": "cs0", "ego_pose_token": f"ep{i}",
            "is_key_frame": True, "filename": name})
    for name, table in rows.items():
        (tables / f"{name}.json").write_text(json.dumps(table))
    return path


# format -> writer(path, n, img_wh, focal) -> the data directory
CAPTURE_FIXTURES = {
    "scannet": make_scannet_fixture,
    "sdfstudio": make_sdfstudio_fixture,
    "phototourism": make_phototourism_fixture,
    "sitcoms3d": make_sitcoms3d_fixture,
    "arkitscenes": make_arkitscenes_fixture,
    "nuscenes": make_nuscenes_fixture,
}
