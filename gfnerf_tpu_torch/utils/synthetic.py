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
"""

from __future__ import annotations

import json
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
                   coverage: bool = False) -> np.ndarray:
    """Analytic render: nearest sphere hit, Lambert-shaded. (N, H, W, 3);
    with ``coverage``, (N, H, W, 4): the fourth channel 1 where a ray hits
    a sphere, 0 on the sky."""
    n = len(c2w)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    imgs = np.zeros((n, h, w, 4 if coverage else 3), np.float32)
    light = np.array([0.4, 0.3, 0.85])
    light = light / np.linalg.norm(light)
    for i in range(n):
        d_cam = np.stack([(xx - cx[i]) / fx[i], -(yy - cy[i]) / fy[i],
                          -np.ones_like(xx)], axis=-1)
        d = d_cam @ c2w[i, :3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[i, :3, 3]
        best_t = np.full((h, w), np.inf, np.float32)
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
        imgs[i, ..., :3] = img
        if coverage:
            imgs[i, ..., 3] = np.isfinite(best_t)
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
