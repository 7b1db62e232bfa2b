"""Synthetic test scenes (analytic renders, no assets needed).

Numpy copies of ``gfnerf_tpu/utils/synthetic.py``'s ``ring_cameras``,
``render_spheres`` and ``make_synthetic_npz``: ring cameras around coloured
spheres, images rendered by direct ray-sphere intersection with Lambert
shading, written as the minimal dataparser's npz files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

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
                   spheres: np.ndarray = SPHERES) -> np.ndarray:
    """Analytic render: nearest sphere hit, Lambert-shaded. (N, H, W, 3)."""
    n = len(c2w)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    imgs = np.zeros((n, h, w, 3), np.float32)
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
        imgs[i] = img
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
