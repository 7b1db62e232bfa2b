"""Ray, sample and march debug visualizations.

Port of ``gfnerf_tpu/utils/plots.py`` (the role of the reference's
``gfnerf/plots.py``, plotly traces and .obj dumps, :6-100): without plotly,
every visualization is an .obj line set or an ASCII .ply coloured point
cloud, loadable in Blender or MeshLab and diffable in tests.
:func:`vis_march_debug` marches through the port's sampler (``fast`` or
``scan``, as the config says; M1 on the card for ``scan``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def vis_rays_obj(rays_o: np.ndarray, rays_d: np.ndarray, output_path,
                 length: float = 5.0, max_rays: int = 256) -> int:
    """Ray segments as an .obj line set (origin -> origin + length*dir)."""
    o = np.asarray(rays_o)[:max_rays]
    d = np.asarray(rays_d)[:max_rays]
    e = o + length * d
    lines = []
    for p in np.concatenate([o, e]):
        lines.append(f"v {p[0]} {p[1]} {p[2]}")
    n = len(o)
    for i in range(n):
        lines.append(f"l {i + 1} {i + 1 + n}")
    Path(output_path).write_text("\n".join(lines) + "\n")
    return n


def vis_samples_ply(world_pts: np.ndarray, values: np.ndarray,
                    valid: np.ndarray, output_path,
                    max_points: int = 200_000) -> int:
    """Sample points as an ASCII .ply coloured by ``values`` (e.g.
    densities or weights) from blue to red; invalid samples dropped, at
    most ``max_points`` kept, evenly spaced."""
    pts = np.asarray(world_pts).reshape(-1, 3)
    val = np.asarray(values).reshape(-1)
    ok = np.asarray(valid).reshape(-1).astype(bool)
    pts, val = pts[ok], val[ok]
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts, val = pts[sel], val[sel]
    v = val - val.min()
    v = v / (v.max() + 1e-12)
    # blue -> red colormap
    r = (255 * v).astype(np.uint8)
    b = (255 * (1 - v)).astype(np.uint8)
    g = np.zeros_like(r)
    header = "\n".join([
        "ply", "format ascii 1.0", f"element vertex {len(pts)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header"])
    body = "\n".join(
        f"{p[0]} {p[1]} {p[2]} {cr} {cg} {cb}"
        for p, cr, cg, cb in zip(pts, r, g, b))
    Path(output_path).write_text(header + "\n" + body + "\n")
    return len(pts)


@torch.no_grad()
def vis_march_debug(oct_dev, rays_o, rays_d, sampler_cfg, output_dir,
                    fineness: float = 1.0) -> dict:
    """March the given rays (numpy (R, 3), on ``oct_dev``'s device) with
    eval noise and dump ``rays.obj`` and ``samples.ply`` (coloured by t),
    with the per-ray sample counts."""
    from gfnerf_tpu_torch.models.gfnerf import sample_rays

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    dev = oct_dev.centers.device
    r = len(rays_o)
    noise = torch.ones((r, sampler_cfg.max_samples), device=dev)
    samples = sample_rays(
        oct_dev, torch.as_tensor(np.asarray(rays_o, np.float32), device=dev),
        torch.as_tensor(np.asarray(rays_d, np.float32), device=dev), noise,
        fineness, sampler_cfg)
    n_rays = vis_rays_obj(rays_o, rays_d, output_dir / "rays.obj")
    n_pts = vis_samples_ply(samples.world_pts.cpu().numpy(),
                            samples.ts.cpu().numpy(),
                            samples.valid.cpu().numpy(),
                            output_dir / "samples.ply")
    nv = samples.num_valid.cpu().numpy()
    return {"rays": n_rays, "points": n_pts,
            "samples_per_ray_mean": float(nv.mean()),
            "samples_per_ray_max": int(nv.max())}
