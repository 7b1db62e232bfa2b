"""Export point clouds, meshes and camera poses from a trained checkpoint.

The port's counterpart of ``scripts/exporter.py`` (the reference's
``ns-export``):

  python -m gfnerf_tpu_torch.export {pointcloud,poses,mesh,tsdf,texture}
      --load-config RUN/config.json [--output-dir DIR] [--num-views N]
      [--downscale-factor K] [--resolution R] [--density-threshold D]
      [--dataparser NAME]

- ``pointcloud``: the train views' depth maps unprojected
  (``point_cloud.ply``);
- ``poses``: the train cameras (``camera_poses.json``);
- ``mesh``: surface nets on the global field's density over [-8, 8]^3
  within the octree's root cube (``mesh.obj``; GF-NeRF pipelines only: it
  locates points in the octree, which gives a point outside its root cube
  the warp of a leaf on the cube's face);
- ``tsdf``: the views' depth fused into a TSDF over [-4, 4]^3
  (``tsdf_mesh.obj``);
- ``texture``: ``mesh.obj`` textured by rendering a short ray toward each
  texel (``mesh.obj``, ``material.mtl``, ``texture.png``; run ``mesh``
  first).

Renders use the checkpoint's step, so a run trained into its focal stage
renders through its block tables (the JAX script renders at step 0, the
init stage).  The TSDF is given camera-z depth in world units (the JAX
script gives it the render's depth: ray length over the model's
``scale_factor``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from gfnerf_tpu_torch.train import DATAPARSERS

MESH_AABB = np.array([[-8.0, -8.0, -8.0], [8.0, 8.0, 8.0]], np.float32)
TSDF_AABB = np.array([[-4.0] * 3, [4.0] * 3], np.float64)


def depth_scale(pipeline) -> float:
    """The factor that undoes the model's division of depth by its
    ``scale_factor`` (1 for the vanilla pipelines)."""
    return float(getattr(getattr(pipeline.config, "model", None),
                         "scale_factor", 1.0))


def mesh_aabb(pipeline) -> np.ndarray:
    """The density mesh's box: ``MESH_AABB`` (the JAX script's) within
    the octree's root cube."""
    tree = pipeline.sampler.tree
    half = np.float32(tree.side_lens[0]) / 2
    lo = np.maximum(MESH_AABB[0], tree.centers[0] - half)
    hi = np.minimum(MESH_AABB[1], tree.centers[0] + half)
    return np.stack([lo, hi]).astype(np.float32)


def camera_render_fn(pipeline, cameras):
    """``render_camera_fn(cameras, i, downscale=k)`` for the exporter: the
    pipeline's ``render_camera`` at the checkpoint's step, on the
    pipeline's device."""
    cams_dev = cameras.to_device(pipeline.device)
    step = int(pipeline.state.step)

    def render(cams, i, downscale=1):
        with torch.no_grad():
            return pipeline.render_camera(cams, cams_dev, i, step,
                                          downscale=downscale)

    return render


def camera_z_render_fn(pipeline, cameras):
    """:func:`camera_render_fn` with depth as camera z in world units, as
    ``exporter.integrate_tsdf`` reads it: the render's depth (distance
    along the unit ray over ``scale_factor``) times ``scale_factor`` over
    the length of the pixel's camera-space direction (x, y, -1)."""
    from gfnerf_tpu_torch.cameras.cameras import get_image_coords

    render = camera_render_fn(pipeline, cameras)
    scale = depth_scale(pipeline)

    def render_z(cams, i, downscale=1):
        out = dict(render(cams, i, downscale=downscale))
        h, w = out["depth"].shape[:2]
        coords = get_image_coords(h, w) * downscale
        dx = (coords[..., 1] - float(cams.cx[i])) / float(cams.fx[i])
        dy = (coords[..., 0] - float(cams.cy[i])) / float(cams.fy[i])
        norm = np.sqrt(dx * dx + dy * dy + 1.0)
        out["depth"] = (out["depth"] * scale / norm[..., None]).astype(
            np.float32)
        return out

    return render_z


@torch.no_grad()
def density_fn(pipeline, pts: np.ndarray) -> np.ndarray:
    """The global field's density (N,) at world points (N, 3): each point
    located in the octree, warped by its volume's projections, and
    evaluated at the init stage (0 where it lies in no valid leaf).  The
    JAX script's closure (scripts/exporter.py:55-67); H1 or H4 on the
    card."""
    from gfnerf_tpu_torch.fields.field import STAGE_INIT, field_density
    from gfnerf_tpu_torch.models.gfnerf import warp_or_identity
    from gfnerf_tpu_torch.sampler.perssampler import locate_points

    x = torch.as_tensor(np.ascontiguousarray(pts, np.float32),
                        device=pipeline.device)
    oct_dev = pipeline.sampler.oct_dev
    _, _, _, trans, _ = locate_points(
        oct_dev, x, pipeline.sampler.sampler_config.locate_iters)
    trc = trans.clamp(0, oct_dev.w2xz.shape[0] - 1)
    warp = warp_or_identity(pipeline.field_cfg, oct_dev, trc, x)
    density, _ = field_density(pipeline.field, warp, trans, STAGE_INIT)
    return density.cpu().numpy()


@torch.no_grad()
def render_rays_fn(pipeline, origins: np.ndarray,
                   directions: np.ndarray) -> np.ndarray:
    """rgb (N, 3) of rays (N, 3) in chunks of the pipeline's
    ``eval_num_rays_per_chunk``, appearance of image 0: a GF-NeRF
    pipeline's render function (the march, H1 and K1 on the card; at the
    focal stage with block 0's table, as the JAX script's block index 0),
    or a vanilla pipeline's ``render_rays``."""
    dev = pipeline.device
    o = torch.as_tensor(np.asarray(origins, np.float32), device=dev)
    d = torch.as_tensor(np.asarray(directions, np.float32), device=dev)
    chunk = pipeline.config.eval_num_rays_per_chunk
    outs = []
    for s in range(0, o.shape[0], chunk):
        if hasattr(pipeline, "sampler"):
            from gfnerf_tpu_torch.fields.field import STAGE_BLOCK

            block = pipeline.stage_of(int(pipeline.state.step)) == STAGE_BLOCK
            out = pipeline._render_chunk(pipeline.field,
                                         pipeline.sampler.oct_dev,
                                         o[s:s + chunk], d[s:s + chunk], 0,
                                         0, block)
        else:
            out = pipeline.render_rays(o[s:s + chunk], d[s:s + chunk], 0)
        outs.append(out["rgb"])
    if not outs:
        return np.zeros((0, 3), np.float32)
    return torch.cat(outs).cpu().numpy()


def read_obj(path: Path):
    """(vertices (V, 3) f32, faces (F, K) int64, 0-based) of an OBJ."""
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            verts.append([float(x) for x in t[1:4]])
        elif t[0] == "f":
            faces.append([int(x.split("/")[0]) - 1 for x in t[1:]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int64))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=["pointcloud", "poses", "mesh",
                                         "tsdf", "texture"])
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exports"))
    parser.add_argument("--num-views", type=int, default=None)
    parser.add_argument("--downscale-factor", type=int, default=4)
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--density-threshold", type=float, default=5.0)
    parser.add_argument("--dataparser", default=None, choices=DATAPARSERS,
                        help="default: guessed from the run's data "
                             "directory")
    args = parser.parse_args(argv)

    from gfnerf_tpu_torch.exporter import exporter
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup

    _, trainer = eval_setup(args.load_config, args.dataparser)
    pipeline = trainer.pipeline
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    cams = exporter.train_outputs(pipeline).cameras

    if args.mode == "pointcloud":
        n = exporter.export_point_cloud(
            camera_render_fn(pipeline, cams), cams, out / "point_cloud.ply",
            num_views=args.num_views, downscale=args.downscale_factor,
            depth_scale=depth_scale(pipeline))
        print(f"wrote {n} points to {out / 'point_cloud.ply'}")
    elif args.mode == "poses":
        n = exporter.export_camera_poses(pipeline, out / "camera_poses.json")
        print(f"wrote {n} poses")
    elif args.mode == "mesh":
        if not hasattr(pipeline, "sampler"):
            raise SystemExit("export mesh: the density mesh locates points "
                             "in the octree of a GF-NeRF pipeline; use "
                             "tsdf for this method")
        n = exporter.export_marching_cubes_mesh(
            lambda pts: density_fn(pipeline, pts), mesh_aabb(pipeline),
            args.resolution, args.density_threshold, out / "mesh.obj")
        print(f"wrote mesh with {n} vertices")
    elif args.mode == "tsdf":
        n = exporter.export_tsdf_mesh(
            camera_z_render_fn(pipeline, cams), cams, TSDF_AABB,
            args.resolution, out / "tsdf_mesh.obj",
            downscale=args.downscale_factor, num_views=args.num_views)
        print(f"wrote TSDF mesh with {n} vertices")
    else:
        mesh_path = out / "mesh.obj"
        if not mesh_path.exists():
            raise SystemExit(f"export texture: no {mesh_path}; run the mesh "
                             "mode first")
        verts, faces = read_obj(mesh_path)
        path = exporter.export_textured_mesh(
            verts, faces, lambda o, d: render_rays_fn(pipeline, o, d), out)
        print(f"wrote textured mesh to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
