"""Export utilities: point clouds, camera poses, TSDF, density and textured
meshes.

Port of ``gfnerf_tpu/exporter/exporter.py`` (nerfstudio's ``exporter/`` and
``scripts/exporter.py``), numpy only.  The functions that render take a
render function instead of the pipeline, since the port's
``render_camera`` also takes the cameras on the device:
``render_camera_fn(cameras, i, downscale=k)`` returns numpy (h, w, C)
``rgb``, ``depth`` and ``accumulation``; ``render_rays_fn(origins,
directions)`` returns (N, 3) colours.  ``gfnerf_tpu_torch.export`` builds
both from a trained run.

Every file is the one the JAX package writes for the same inputs: the PLY
bytes, the TSDF arrays, the OBJ and MTL text and the texture's pixels.  The
surface-nets faces, the texel rays and the texture atlas are computed for
all faces at once, in the JAX package's order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from gfnerf_tpu_torch.cameras.cameras import get_image_coords
from gfnerf_tpu_torch.utils.image_io import write_png


def write_ply(path: Path, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None):
    """Binary little-endian PLY: float x y z [nx ny nz] [uchar red green
    blue] per vertex (colours in [0, 1], clipped and truncated to 0-255)."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    fields = [("p", "<f4", (3,))]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        fields.append(("n", "<f4", (3,)))
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        fields.append(("c", "u1", (3,)))
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props + ["end_header", ""])
    rows = np.empty(n, np.dtype(fields))
    if n:
        rows["p"] = np.asarray(points).reshape(n, 3)
        if normals is not None:
            rows["n"] = np.asarray(normals).reshape(n, 3)
        if colors is not None:
            rows["c"] = (np.clip(np.asarray(colors).reshape(n, 3), 0, 1)
                         * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rows.tobytes())


def train_outputs(pipeline):
    """The train split's dataparser outputs of either pipeline kind."""
    dm = getattr(pipeline, "datamanager", None)
    return dm.train_dataparser_outputs if dm is not None \
        else pipeline.train_outputs


def export_point_cloud(render_camera_fn, cameras, output_path: Path,
                       num_views: Optional[int] = None, downscale: int = 4,
                       min_accumulation: float = 0.5,
                       depth_scale: float = 1.0) -> int:
    """Unproject the first ``num_views`` cameras' rendered depth maps into
    a coloured point cloud, keeping pixels whose accumulation exceeds
    ``min_accumulation`` (exporter_utils.py generate_point_cloud).
    ``depth_scale`` undoes the model's division of depth by its
    ``scale_factor``.  Returns the number of points."""
    n = len(cameras) if num_views is None else min(num_views, len(cameras))
    pts, cols = [], []
    for i in range(n):
        out = render_camera_fn(cameras, i, downscale=downscale)
        depth = out["depth"][..., 0] * depth_scale
        acc = out["accumulation"][..., 0]
        rgb = out["rgb"]
        h, w = depth.shape
        coords = get_image_coords(h, w) * downscale
        y, x = coords[..., 0], coords[..., 1]
        fx, fy = float(cameras.fx[i]), float(cameras.fy[i])
        cx, cy = float(cameras.cx[i]), float(cameras.cy[i])
        d_cam = np.stack([(x - cx) / fx, -(y - cy) / fy,
                          -np.ones_like(x)], -1)
        c2w = np.asarray(cameras.camera_to_worlds[i])
        d_world = d_cam @ c2w[:3, :3].T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        p = c2w[:3, 3][None, None] + depth[..., None] * d_world
        mask = acc > min_accumulation
        pts.append(p[mask])
        cols.append(rgb[mask])
    points = np.concatenate(pts) if pts else np.zeros((0, 3))
    colors = np.concatenate(cols) if cols else np.zeros((0, 3))
    write_ply(output_path, points, colors=colors)
    return len(points)


def export_camera_poses(pipeline, output_path: Path) -> int:
    """The train cameras as JSON: per frame its file and 4x4 camera to
    world (scripts/exporter.py ExportCameraPoses)."""
    outputs = train_outputs(pipeline)
    cams = outputs.cameras
    frames = []
    for i in range(len(cams)):
        c2w = np.eye(4)
        c2w[:3, :4] = np.asarray(cams.camera_to_worlds[i])
        frames.append({
            "file_path": str(outputs.image_filenames[i]),
            "transform": c2w.tolist(),
        })
    Path(output_path).write_text(json.dumps(frames, indent=2))
    return len(frames)


def integrate_tsdf(voxel_origin, voxel_size, dims, c2w, K, depth, color=None,
                   tsdf=None, weights=None, colors=None,
                   truncation_margin: float = 5.0):
    """Projective TSDF integration of one depth (and colour) image
    (exporter/tsdf_utils.py:170-273): every voxel projected into the
    camera, the nearest pixel's depth, the truncated signed distance
    ``(depth - voxel_z) / trunc`` clamped to [-1, 1], a running weighted
    average of values and colours.  ``depth`` is camera z (along -z)."""
    nx, ny, nz = dims
    if tsdf is None:
        tsdf = np.ones(dims, np.float32)
        weights = np.zeros(dims, np.float32)
        colors = np.zeros((*dims, 3), np.float32)
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                indexing="ij"), -1).reshape(-1, 3)
    pts = voxel_origin[None] + (grid + 0.5) * voxel_size[None]
    w2c = np.linalg.inv(np.concatenate(
        [c2w, [[0, 0, 0, 1]]], axis=0) if c2w.shape[0] == 3 else c2w)
    cam = (w2c[:3, :3] @ pts.T + w2c[:3, 3:4]).T       # (N, 3)
    z = -cam[:, 2]                                     # -z forward
    uv = (K @ np.stack([cam[:, 0], -cam[:, 1], z], 0)).T
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uv[:, 0] / uv[:, 2]
        v = uv[:, 1] / uv[:, 2]
    h, w = depth.shape[:2]
    ui = np.clip(u, 0, w - 1).astype(np.int32)
    vi = np.clip(v, 0, h - 1).astype(np.int32)
    valid = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d_img = depth[vi, ui]
    valid &= d_img > 0
    trunc = truncation_margin * float(voxel_size[0])
    sdf = np.clip((d_img - z) / trunc, -1.0, 1.0)
    upd = valid & (sdf > -1.0)
    sdf = np.where(upd, sdf, 0.0)
    wnew = upd.astype(np.float32)
    tsdf_f = tsdf.reshape(-1)
    w_f = weights.reshape(-1)
    c_f = colors.reshape(-1, 3)
    wsum = w_f + wnew
    safe = np.maximum(wsum, 1e-9)
    tsdf_f[:] = np.where(upd, (tsdf_f * w_f + sdf * wnew) / safe, tsdf_f)
    if color is not None:
        cimg = color[vi, ui]
        c_f[:] = np.where(upd[:, None],
                          (c_f * w_f[:, None] + cimg * wnew[:, None])
                          / safe[:, None], c_f)
    w_f[:] = wsum
    return tsdf, weights, colors


def export_tsdf_mesh(render_camera_fn, cameras, aabb: np.ndarray,
                     resolution: int, output_path: Path,
                     downscale: int = 4, num_views: int = None) -> int:
    """TSDF-fusion mesh (exporter/tsdf_utils.py:274-340): depth and rgb
    rendered from every ``len // num_views``-th camera, fused into a voxel
    TSDF over ``aabb``, its zero crossing extracted by the surface-nets
    extractor, written as OBJ.  ``render_camera_fn``'s depth must be
    camera z in world units (:func:`integrate_tsdf`).  Returns the number
    of vertices."""
    lo, hi = np.asarray(aabb[0], np.float64), np.asarray(aabb[1], np.float64)
    dims = (resolution,) * 3
    voxel_size = (hi - lo) / resolution
    tsdf = weights = colors = None
    n = len(cameras) if num_views is None else min(num_views, len(cameras))
    step = max(len(cameras) // n, 1)
    for i in range(0, len(cameras), step):
        out = render_camera_fn(cameras, i, downscale=downscale)
        depth = np.asarray(out["depth"])[..., 0]
        rgb = np.asarray(out["rgb"])
        K = np.array([[cameras.fx[i] / downscale, 0,
                       cameras.cx[i] / downscale],
                      [0, cameras.fy[i] / downscale,
                       cameras.cy[i] / downscale],
                      [0, 0, 1]], np.float64)
        tsdf, weights, colors = integrate_tsdf(
            lo, voxel_size, dims, np.asarray(cameras.camera_to_worlds[i]),
            K, depth, rgb, tsdf, weights, colors)
    observed = weights > 0
    field = np.where(observed, tsdf, 1.0)

    # the zero crossing by the density mesh's surface nets, on -tsdf
    # (inside positive)
    def fn(pts):
        ijk = np.clip(((pts - lo[None]) / voxel_size[None] - 0.5), 0,
                      resolution - 1).astype(np.int32)
        return -field[ijk[:, 0], ijk[:, 1], ijk[:, 2]]

    return export_marching_cubes_mesh(fn, np.stack([lo, hi]),
                                      resolution - 1, 0.0, output_path)


def export_textured_mesh(verts: np.ndarray, faces: np.ndarray,
                         render_rays_fn, output_dir: Path,
                         texture_px_per_face: int = 8,
                         offset: float = 0.05) -> Path:
    """Texture a mesh with a square patch of the atlas per face (the
    reference's per-face unwrap, exporter/texture_utils.py:82-216): each
    texel's colour is rendered along a short ray toward the surface along
    the face normal.  Writes ``mesh.obj``, ``material.mtl`` and
    ``texture.png`` (the atlas flipped vertically: OBJ texture rows run
    bottom up).  Returns the OBJ's path."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    f = np.asarray(faces)
    v = np.asarray(verts)
    nf = len(f)
    ps = texture_px_per_face
    atlas_cols = int(np.ceil(np.sqrt(nf)))
    atlas_rows = int(np.ceil(nf / atlas_cols))

    # face normals (quads assumed planar enough)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 3 if f.shape[1] == 4 else 2]] - v[f[:, 0]]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-12

    uu, vv = np.meshgrid((np.arange(ps) + 0.5) / ps,
                         (np.arange(ps) + 0.5) / ps, indexing="xy")
    uu, vv = uu.reshape(-1)[:, None], vv.reshape(-1)[:, None]
    corner = [v[f[:, k]][:, None] for k in range(f.shape[1])]   # (nf, 1, 3)
    if f.shape[1] == 4:
        p = ((1 - uu) * ((1 - vv) * corner[0] + vv * corner[3])
             + uu * ((1 - vv) * corner[1] + vv * corner[2]))
    else:
        w0 = np.clip(1 - uu - vv, 0, None)
        p = w0 * corner[0] + uu * corner[1] + vv * corner[2]
    origins = (p + offset * nrm[:, None]).reshape(-1, 3)
    dirs = np.broadcast_to(-nrm[:, None], p.shape).reshape(-1, 3)
    rgb = np.asarray(render_rays_fn(origins, dirs))    # (nf * ps * ps, 3)
    tex = np.zeros((atlas_rows * atlas_cols, ps, ps, 3), np.float32)
    tex[:nf] = rgb.reshape(nf, ps, ps, 3)
    tex = tex.reshape(atlas_rows, atlas_cols, ps, ps, 3).transpose(
        0, 2, 1, 3, 4).reshape(atlas_rows * ps, atlas_cols * ps, 3)

    write_png(output_dir / "texture.png",
              (np.clip(tex[::-1], 0, 1) * 255).astype(np.uint8))
    (output_dir / "material.mtl").write_text(
        "newmtl textured\nmap_Kd texture.png\n")
    obj = ["mtllib material.mtl", "usemtl textured"]
    for q in v:
        obj.append(f"v {q[0]} {q[1]} {q[2]}")
    th, tw = atlas_rows * ps, atlas_cols * ps
    for fi in range(nf):
        r, c = divmod(fi, atlas_cols)
        x0, y0 = c * ps / tw, r * ps / th
        x1, y1 = (c + 1) * ps / tw, (r + 1) * ps / th
        for (x, y) in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)):
            obj.append(f"vt {x} {y}")
    for fi, quad in enumerate(f):
        t0 = 4 * fi + 1
        if f.shape[1] == 4:
            obj.append(
                f"f {quad[0]+1}/{t0} {quad[1]+1}/{t0+1} "
                f"{quad[2]+1}/{t0+2} {quad[3]+1}/{t0+3}")
        else:
            obj.append(f"f {quad[0]+1}/{t0} {quad[1]+1}/{t0+1} "
                       f"{quad[2]+1}/{t0+2}")
    out_path = output_dir / "mesh.obj"
    out_path.write_text("\n".join(obj) + "\n")
    return out_path


def export_marching_cubes_mesh(density_fn, aabb: np.ndarray,
                               resolution: int, threshold: float,
                               output_path: Path, chunk: int = 65536) -> int:
    """An isosurface mesh of a density field by naive surface nets: a
    vertex at the centre of each cell whose corners are mixed, a quad
    across each grid edge whose ends differ.  ``density_fn``: (N, 3) ->
    (N,), evaluated on the (resolution + 1)^3 grid points in chunks.
    Writes OBJ; returns the number of vertices."""
    lo, hi = aabb[0], aabb[1]
    axes = [np.linspace(lo[d], hi[d], resolution + 1, dtype=np.float32)
            for d in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vals = np.empty(len(grid), np.float32)
    for s in range(0, len(grid), chunk):
        vals[s:s + chunk] = np.asarray(density_fn(grid[s:s + chunk]))
    occ = (vals >= threshold).reshape(
        resolution + 1, resolution + 1, resolution + 1)

    # cells with mixed corner occupancy get a vertex at their center
    c = occ
    corner_sum = (
        c[:-1, :-1, :-1].astype(np.int32) + c[1:, :-1, :-1] + c[:-1, 1:, :-1]
        + c[:-1, :-1, 1:] + c[1:, 1:, :-1] + c[1:, :-1, 1:] + c[:-1, 1:, 1:]
        + c[1:, 1:, 1:])
    mixed = (corner_sum > 0) & (corner_sum < 8)
    idx_grid = np.full(mixed.shape, -1, np.int64)
    cells = np.argwhere(mixed)
    idx_grid[mixed] = np.arange(len(cells))
    cell_size = (hi - lo) / resolution
    verts = lo[None] + (cells + 0.5) * cell_size[None]

    # an edge between adjacent grid points whose occupancy differs spans
    # the 4 cells around it: a quad (i0, i1, i3, i2), where i1 and i2 step
    # back along the next two axes and i3 along both
    faces = []
    for axis in range(3):
        a = occ.take(np.arange(resolution), axis=axis)
        b = occ.take(np.arange(1, resolution + 1), axis=axis)
        sl = [slice(1, resolution)] * 3
        sl[axis] = slice(0, resolution)
        pos = np.argwhere((a != b)[tuple(sl)])
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        pos[:, a1] += 1
        pos[:, a2] += 1
        p1 = pos.copy()
        p1[:, a1] -= 1
        p2 = pos.copy()
        p2[:, a2] -= 1
        p3 = p1.copy()
        p3[:, a2] -= 1
        quad = np.stack([idx_grid[tuple(q.T)] for q in (pos, p1, p3, p2)],
                        axis=1)
        faces.append(quad[quad.min(axis=1) >= 0])
    faces = np.concatenate(faces)
    with open(output_path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for q in faces:
            f.write(f"f {q[0]+1} {q[1]+1} {q[2]+1} {q[3]+1}\n")
    return len(verts)
