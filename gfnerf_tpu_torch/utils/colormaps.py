"""Colormaps for depth and accumulation images.

Copy of ``gfnerf_tpu/utils/colormaps.py`` (nerfstudio's
``utils/colormaps.py``), numpy only: a turbo-style map for depth and
accumulation, used by the viewer's ``/render`` and the trainer's eval
images.
"""

from __future__ import annotations

import numpy as np

# compact 16-stop turbo approximation (interpolated)
_TURBO = np.array([
    [0.19, 0.07, 0.23], [0.27, 0.23, 0.69], [0.27, 0.39, 0.95],
    [0.19, 0.55, 0.93], [0.10, 0.70, 0.74], [0.13, 0.80, 0.54],
    [0.31, 0.88, 0.35], [0.53, 0.93, 0.21], [0.72, 0.95, 0.15],
    [0.88, 0.89, 0.15], [0.97, 0.77, 0.19], [0.99, 0.60, 0.16],
    [0.95, 0.41, 0.10], [0.84, 0.25, 0.05], [0.69, 0.12, 0.02],
    [0.48, 0.02, 0.01],
], np.float32)


def apply_colormap(x: np.ndarray) -> np.ndarray:
    """x (H, W) or (H, W, 1) in [0, 1] -> (H, W, 3) turbo colors."""
    x = np.asarray(x)
    if x.ndim == 3:
        x = x[..., 0]
    x = np.clip(x, 0.0, 1.0) * (len(_TURBO) - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, len(_TURBO) - 1)
    t = (x - lo)[..., None]
    return _TURBO[lo] * (1 - t) + _TURBO[hi] * t


def apply_depth_colormap(depth: np.ndarray,
                         accumulation: np.ndarray | None = None,
                         near: float | None = None,
                         far: float | None = None) -> np.ndarray:
    """Depth normalized to [near, far] (the image's own range by default)
    and colormapped; optionally modulated by the accumulation."""
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    near = float(np.min(depth)) if near is None else near
    far = float(np.max(depth)) if far is None else far
    x = (depth - near) / max(far - near, 1e-10)
    img = apply_colormap(x)
    if accumulation is not None:
        acc = np.asarray(accumulation)
        if acc.ndim == 3:
            acc = acc[..., 0]
        img = img * acc[..., None]
    return img
