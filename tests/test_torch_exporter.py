"""The port's exporter (``gfnerf_tpu_torch/exporter``, ``export.py``) and
plots (``utils/plots.py``) against the JAX package's on the CPU.

- ``write_ply``: the same bytes; ``integrate_tsdf``: the same arrays;
  ``export_tsdf_mesh`` (the analytic sphere of tests/test_exporter_tsdf.py)
  and ``export_marching_cubes_mesh`` (an analytic density): the same OBJ
  text, the surface nets' faces computed at once in the JAX loop's order;
  ``export_textured_mesh``: the same OBJ and MTL, and ``texture.png``'s
  pixels equal to the JAX one's as cv2 reads it.
- ``export.density_fn`` against the JAX script's closure
  (scripts/exporter.py:55-67) with the same field and octree: 1e-5 of the
  output's scale in the packed layout, 2e-4 in the anchored one (the
  tolerance of tests/test_torch_hash_encoding.py's anchored density).
- ``export_point_cloud`` through both packages' ``gf-nerf-tiny`` pipelines
  on the same scene, the JAX field's weights carried into the port: the
  renders to the pipeline tests' tolerance (1e-4 relative, 1e-5
  absolute), the same count of points.
- Two traits of the JAX package that the port does not share: its
  exporter and viewer render at step 0 (the init stage, whatever the
  checkpoint's step), and its TSDF export fuses the render's depth (ray
  length over ``scale_factor``) as if it were camera z in world units.
- ``python -m gfnerf_tpu_torch.export`` in every mode on a CPU run.
- ``vis_rays_obj``/``vis_samples_ply``: the same text; ``vis_march_debug``
  the same files and counts on the same octree.
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)
from torch_parity import field_pair, octree_pair, tiny_rays, tiny_tree


def _ring_cams(n=12, wh=(64, 48), focal=60.0):
    """(JAX CamerasHost, port CamerasHost) of one ring of cameras."""
    from gfnerf_tpu.data.dataparsers.base import CamerasHost as JaxCams
    from gfnerf_tpu.utils.synthetic import ring_cameras
    from gfnerf_tpu_torch.data.dataparsers.base import CamerasHost

    c2w, fx, fy, cx, cy, w, h = ring_cameras(n, radius=3.0, height=0.5,
                                             img_wh=wh, focal=focal)
    kw = dict(camera_to_worlds=c2w, fx=fx, fy=fy, cx=cx, cy=cy,
              width=np.full(n, w, np.int32), height=np.full(n, h, np.int32))
    return JaxCams(**kw), CamerasHost(**kw)


def _sphere_hits(cams, i, downscale=1, radius=1.0):
    """(t along unit rays, hit mask, camera-space direction norm) of the
    unit sphere from camera i at the pixel centres (y + 0.5, x + 0.5) *
    downscale, as the renders place them."""
    c2w = np.asarray(cams.camera_to_worlds[i], np.float64)
    h = int(cams.height[i]) // downscale
    w = int(cams.width[i]) // downscale
    yy, xx = np.meshgrid((np.arange(h) + 0.5) * downscale,
                         (np.arange(w) + 0.5) * downscale, indexing="ij")
    d_cam = np.stack([(xx - cams.cx[i]) / cams.fx[i],
                      -(yy - cams.cy[i]) / cams.fy[i], -np.ones_like(xx)],
                     -1)
    norm = np.linalg.norm(d_cam, axis=-1)
    d = (d_cam @ c2w[:3, :3].T) / norm[..., None]
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - float(o @ o - radius * radius)
    t = -b - np.sqrt(np.maximum(disc, 0))
    return t, (disc > 0) & (t > 0), norm


def _sphere_render(cams, i, downscale=1, depth="z", scale=1.0):
    """The unit sphere as a render function returns it: depth as camera z
    in world units (``depth="z"``) or as the models return it, ray length
    over ``scale`` (``depth="ray"``); red where hit."""
    t, hit, norm = _sphere_hits(cams, i, downscale)
    dep = t / norm if depth == "z" else t / scale
    rgb = np.zeros((*t.shape, 3), np.float32)
    rgb[..., 0] = hit
    rgb[..., 1] = np.where(hit, 0.5 + 0.25 * np.tanh(t - 2.0), 0.0)
    return {"depth": np.where(hit, dep, 0.0)[..., None].astype(np.float32),
            "rgb": rgb, "accumulation": hit[..., None].astype(np.float32)}


def _density(pts):
    """An analytic density: two overlapping blobs and a slab."""
    p = np.asarray(pts, np.float64)
    a = 20.0 * np.exp(-4.0 * np.sum((p - [0.3, 0.0, 0.1]) ** 2, -1))
    b = 12.0 * np.exp(-6.0 * np.sum((p + [0.5, 0.4, 0.0]) ** 2, -1))
    slab = 8.0 * (np.abs(p[:, 2] + 0.9) < 0.15)
    return (a + b + slab).astype(np.float32)


# ---- writers and meshes, exact ----


@pytest.mark.parametrize("case", ["points", "colors", "normals+colors",
                                  "float32", "empty"])
def test_write_ply_matches_jax(tmp_path, case):
    from gfnerf_tpu.exporter.exporter import write_ply as jax_write
    from gfnerf_tpu_torch.exporter.exporter import write_ply

    rng = np.random.default_rng(0)
    n = 0 if case == "empty" else 57
    pts = rng.normal(0, 3, (n, 3))
    if case == "float32":
        pts = pts.astype(np.float32)
    kw = {}
    if case != "points":
        kw["colors"] = rng.uniform(-0.2, 1.2, (n, 3))   # clipped
    if case == "normals+colors":
        kw["normals"] = rng.normal(size=(n, 3))
    jax_write(tmp_path / "j.ply", pts, **kw)
    write_ply(tmp_path / "t.ply", pts, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply"
                                                 ).read_bytes()


def test_integrate_tsdf_matches_jax():
    from gfnerf_tpu.exporter.exporter import integrate_tsdf as jax_integrate
    from gfnerf_tpu_torch.exporter.exporter import integrate_tsdf

    rng = np.random.default_rng(1)
    dims = (12, 10, 14)
    origin = np.array([-1.0, -1.2, -3.5])
    vs = np.array([0.2, 0.25, 0.22])
    K = np.array([[40.0, 0, 16], [0, 42.0, 12], [0, 0, 1]])
    views = []
    for k in range(3):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = [0.1 * k, -0.05 * k, 0.2 * k]
        depth = rng.uniform(1.5, 3.5, (24, 32)).astype(np.float32)
        depth[rng.random((24, 32)) < 0.1] = 0.0
        views.append((c2w, depth, rng.random((24, 32, 3)).astype(np.float32)))
    state_j = state_t = (None, None, None)
    for c2w, depth, color in views:
        state_j = jax_integrate(origin, vs, dims, c2w, K, depth, color,
                                *state_j)
        state_t = integrate_tsdf(origin, vs, dims, c2w, K, depth, color,
                                 *state_t)
        for a, b in zip(state_t, state_j):
            np.testing.assert_array_equal(a, b)
    assert state_t[1].sum() > 0


def test_tsdf_mesh_matches_jax_on_sphere(tmp_path):
    """tests/test_exporter_tsdf.py's sphere, through both exporters: the
    same OBJ text, which hugs the unit sphere."""
    from gfnerf_tpu.exporter.exporter import export_tsdf_mesh as jax_tsdf
    from gfnerf_tpu_torch.exporter.exporter import export_tsdf_mesh

    jcams, tcams = _ring_cams()
    aabb = np.array([[-1.6] * 3, [1.6] * 3])
    nj = jax_tsdf(_sphere_render, jcams, aabb, 32, tmp_path / "j.obj",
                  downscale=2, num_views=6)
    nt = export_tsdf_mesh(_sphere_render, tcams, aabb, 32,
                          tmp_path / "t.obj", downscale=2, num_views=6)
    text = (tmp_path / "t.obj").read_text()
    assert nt == nj > 50
    assert text == (tmp_path / "j.obj").read_text()
    verts = np.array([[float(x) for x in line.split()[1:]]
                      for line in text.splitlines() if line[0] == "v"])
    assert 0.8 < np.median(np.linalg.norm(verts, axis=-1)) < 1.2


@pytest.mark.parametrize("resolution,threshold,dtype",
                         [(24, 5.0, np.float32), (31, 2.0, np.float64)])
def test_marching_cubes_matches_jax(tmp_path, resolution, threshold, dtype):
    from gfnerf_tpu.exporter.exporter import \
        export_marching_cubes_mesh as jax_mesh
    from gfnerf_tpu_torch.exporter.exporter import export_marching_cubes_mesh

    aabb = np.array([[-1.5, -1.4, -1.3], [1.4, 1.5, 1.2]], dtype)
    nj = jax_mesh(_density, aabb, resolution, threshold, tmp_path / "j.obj",
                  chunk=4096)
    nt = export_marching_cubes_mesh(_density, aabb, resolution, threshold,
                                    tmp_path / "t.obj", chunk=4096)
    text = (tmp_path / "t.obj").read_text()
    assert nt == nj > 100 and text.count("\nf ") > 100
    assert text == (tmp_path / "j.obj").read_text()


@pytest.mark.parametrize("kind", ["quads", "triangles"])
def test_textured_mesh_matches_jax(tmp_path, kind):
    """A surface-nets mesh of the analytic density (quads) or a fan of
    triangles, textured through both exporters with an analytic colour of
    the ray: OBJ and MTL text equal, ``texture.png``'s pixels equal to
    what cv2 reads of the JAX one (BGR, turned to RGB)."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu.exporter.exporter import \
        export_textured_mesh as jax_texture
    from gfnerf_tpu_torch.export import read_obj
    from gfnerf_tpu_torch.exporter.exporter import (
        export_marching_cubes_mesh, export_textured_mesh)
    from gfnerf_tpu_torch.utils.image_io import read_png

    if kind == "quads":
        export_marching_cubes_mesh(_density, np.array([[-1.5] * 3, [1.5] * 3],
                                                      np.float32), 12, 5.0,
                                   tmp_path / "m.obj")
        verts, faces = read_obj(tmp_path / "m.obj")
        assert faces.shape[1] == 4 and len(faces) > 20
    else:
        rng = np.random.default_rng(2)
        verts = rng.normal(size=(9, 3)).astype(np.float32)
        faces = np.array([[0, i, i + 1] for i in range(1, 8)], np.int64)

    def render_rays_fn(o, d):
        return np.stack([0.5 + 0.5 * np.sin(3 * o[:, 0]),
                         np.abs(d[:, 1]), 0.3 + 0.2 * o[:, 2]], -1)

    jax_texture(verts, faces, render_rays_fn, tmp_path / "j",
                texture_px_per_face=4)
    export_textured_mesh(verts, faces, render_rays_fn, tmp_path / "t",
                         texture_px_per_face=4)
    for name in ("mesh.obj", "material.mtl"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text(), name
    want = cv2.imread(str(tmp_path / "j" / "texture.png"))[..., ::-1]
    got = read_png(tmp_path / "t" / "texture.png")
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0


# ---- the export script's functions against the JAX script's ----


def _jax_script_density(oct_dev, params, statics, jcfg, locate_iters, pts):
    """scripts/exporter.py:55-67's closure, as it is (eager), with its
    anchors and warped points."""
    import jax.numpy as jnp
    from gfnerf_tpu.fields.field import STAGE_INIT, field_density
    from gfnerf_tpu.sampler.perssampler import locate_points, warp_points

    pts_j = jnp.asarray(pts, jnp.float32)
    _, _, _, trans, _ = locate_points(oct_dev, pts_j, locate_iters)
    trc = jnp.clip(trans, 0, oct_dev.w2xz.shape[0] - 1)
    warp = warp_points(oct_dev, trc, pts_j)
    density, _ = field_density(params, statics, jcfg, warp, trans,
                               STAGE_INIT)
    return np.asarray(density), np.asarray(trans), np.asarray(warp)


@pytest.mark.parametrize("layout,tol", [("packed", 1e-5), ("anchored", 2e-4)])
def test_density_fn_matches_jax_script(layout, tol):
    """``export.density_fn`` against the JAX script's closure on points
    across the tiny octree's root cube, in its three steps:
    - ``locate_points``: the same anchors (a fifth or more outside every
      valid leaf, density 0 in both);
    - ``warp_points``: the same warped points to 1e-6 where valid;
    - ``field_density`` on the closure's warped points against the JAX
      field compiled as the JAX package runs it (``jax.jit``): ``tol`` of
      the output's scale.
    End to end the script runs eagerly, and eager XLA:CPU divides
    ``(warp + 1.5) / 3`` where the compiled field (and the port) multiply
    by 1/3; near a fine hash level's cell edge that ulp, and the warp's,
    moves a density of about 3 by up to about 2e-4.  So end to end the
    port is held to ``tol`` of the scale or, where that is tighter, to no
    farther from the eager closure than the JAX package's own compiled
    field is (measured: packed 1.7e-4 against 1.9e-4; anchored 1.2e-4,
    within 2e-4 of the scale)."""
    import jax

    from gfnerf_tpu.fields.field import STAGE_INIT as J_INIT
    from gfnerf_tpu.fields.field import field_density as jax_density
    from gfnerf_tpu_torch.export import density_fn
    from gfnerf_tpu_torch.fields.field import field_density
    from gfnerf_tpu_torch.sampler.perssampler import (SamplerConfig,
                                                      locate_points,
                                                      warp_points)

    over = ({} if layout == "packed" else
            dict(hash_layout="anchored", log2_hashmap_size=12, num_levels=4,
                 features_per_level=2))
    jcfg, params, statics, field = field_pair(seed=3, block_scale=0.3,
                                              mlp_dtype="float32", **over)
    joct, toct = octree_pair()
    tree = tiny_tree()
    iters = 14   # the tiny tree is 5 levels deep
    c, s = np.asarray(tree.centers[0]), float(tree.side_lens[0])
    rng = np.random.default_rng(4)
    pts = (c + rng.uniform(-0.6, 0.6, (3000, 3)) * s).astype(np.float32)
    pipe = types.SimpleNamespace(
        device=torch.device("cpu"), field=field, field_cfg=field.cfg,
        sampler=types.SimpleNamespace(
            oct_dev=toct, sampler_config=SamplerConfig(locate_iters=iters)))
    got = density_fn(pipe, pts)
    want, jtrans, jwarp = _jax_script_density(joct, params, statics, jcfg,
                                              iters, pts)
    assert got.shape == want.shape == (3000,)
    # the steps
    x = torch.as_tensor(pts)
    trans = locate_points(toct, x, iters)[3]
    np.testing.assert_array_equal(trans.numpy(), jtrans)
    valid = jtrans >= 0
    assert 0.2 < valid.mean() < 0.8
    warp = warp_points(toct, trans.clamp(0, toct.w2xz.shape[0] - 1), x)
    np.testing.assert_allclose(warp.numpy()[valid], jwarp[valid], rtol=0,
                               atol=1e-6)
    compiled = np.asarray(jax.jit(lambda w, a: jax_density(
        params, statics, jcfg, w, a, J_INIT)[0])(jwarp, jtrans))
    with torch.no_grad():
        on_jax_warp = field_density(field, torch.as_tensor(np.array(jwarp)),
                                    trans)[0].numpy()
    scale = max(1.0, float(np.abs(compiled).max()))
    np.testing.assert_allclose(on_jax_warp, compiled, rtol=tol,
                               atol=tol * scale)
    # end to end
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.all(got[~valid] == 0)
    assert np.abs(got - want).max() <= max(tol * scale,
                                           np.abs(compiled - want).max())


@pytest.fixture(scope="module")
def pipeline_pair(tmp_path_factory):
    """Both packages' ``gf-nerf-tiny`` pipelines on one scene (12 views at
    32x24), the port's field given the JAX field's weights."""
    from gfnerf_tpu.configs.method_configs import \
        gf_nerf_tiny_config as jax_tiny
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.fields.field import params_from_jax
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz
    from torch_parity import jax_minimal_parser

    tmp = tmp_path_factory.mktemp("export_pipes")
    scene = make_synthetic_npz(tmp / "scene", n_train=12, n_val=2,
                               img_wh=(32, 24))
    jp = jax_tiny().pipeline.build(jax_minimal_parser(scene), tmp / "j")
    cfg = gf_nerf_tiny_config()
    tp = cfg.pipeline.build(MinimalDataParser(MinimalDataParserConfig(
        data=scene)), tmp / "t", device="cpu")
    assert dataclasses.asdict(tp.sampler.sampler_config) == \
        dataclasses.asdict(jp.sampler.sampler_config)
    tp.field.load_state_dict(params_from_jax(
        jp.state.params, jp.statics, tp.field_cfg,
        device="cpu").state_dict())
    return jp, tp


def test_point_cloud_through_both_pipelines(pipeline_pair, tmp_path):
    from gfnerf_tpu.exporter.exporter import \
        export_point_cloud as jax_point_cloud
    from gfnerf_tpu_torch.export import camera_render_fn, depth_scale
    from gfnerf_tpu_torch.exporter.exporter import export_point_cloud

    jp, tp = pipeline_pair
    cams = tp.datamanager.train_dataparser_outputs.cameras
    render = camera_render_fn(tp, cams)
    jcams = jp.datamanager.train_dataparser_outputs.cameras
    for i in (0, 5):
        want = jp.render_camera(jcams, i, step=0, downscale=2)
        got = render(cams, i, downscale=2)
        for k in ("rgb", "depth", "accumulation"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    nj = jax_point_cloud(jp, tmp_path / "j.ply", num_views=3, downscale=2)
    nt = export_point_cloud(render, cams, tmp_path / "t.ply", num_views=3,
                            downscale=2, depth_scale=depth_scale(tp))
    assert nt == nj > 0
    head = b"end_header\n"
    rows = np.dtype([("p", "<f4", (3,)), ("c", "u1", (3,))])
    gj, gt = ((tmp_path / n).read_bytes() for n in ("j.ply", "t.ply"))
    pj = np.frombuffer(gj[gj.index(head) + len(head):], rows)
    pt = np.frombuffer(gt[gt.index(head) + len(head):], rows)
    np.testing.assert_allclose(pt["p"], pj["p"], rtol=1e-4, atol=1e-5)
    assert np.abs(pt["c"].astype(int) - pj["c"]).max() <= 1


# ---- the JAX package's traits ----


class _StubPipeline:
    """A pipeline that records the step each render is asked for (its
    state's step, 43, in the focal stage) and renders the unit sphere with
    the models' depth: ray length over ``scale_factor`` 10.  ``jax_style``:
    the JAX signature ``render_camera(cams, idx, step=, downscale=)``,
    else the port's ``(cams, cams_dev, idx, step, downscale=)``."""

    def __init__(self, jax_style: bool, cams, step: int = 43):
        self.jax_style = jax_style
        self.steps = []
        self.state = types.SimpleNamespace(step=step)
        self.device = torch.device("cpu")
        self.config = types.SimpleNamespace(
            model=types.SimpleNamespace(scale_factor=10.0))
        self.train_outputs = types.SimpleNamespace(cameras=cams)

    def render_camera(self, cams, *args, step=None, downscale=1):
        if self.jax_style:
            (idx,) = args
        else:
            _, idx, step = args
        self.steps.append(int(step))
        return _sphere_render(cams, idx, downscale, "ray", 10.0)


def test_renders_at_the_checkpoint_step_unlike_jax(tmp_path):
    """A reference-side trait: the JAX exporter and viewer render at step 0
    (exporter.py:61, server.py:828), so a run trained into its focal stage
    is exported and viewed through its global model alone.  The port's
    export functions and viewer pass the pipeline's step (as its render
    script does)."""
    from gfnerf_tpu.exporter.exporter import \
        export_point_cloud as jax_point_cloud
    from gfnerf_tpu.viewer.server import ViewerServer as JaxViewer
    from gfnerf_tpu_torch.export import camera_render_fn
    from gfnerf_tpu_torch.exporter.exporter import export_point_cloud
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    jcams, tcams = _ring_cams(4, (16, 12), 15.0)
    jpipe, tpipe = _StubPipeline(True, jcams), _StubPipeline(False, tcams)
    jax_point_cloud(jpipe, tmp_path / "j.ply", num_views=2)
    export_point_cloud(camera_render_fn(tpipe, tcams), tcams,
                       tmp_path / "t.ply", num_views=2)
    assert jpipe.steps == [0, 0] and tpipe.steps == [43, 43]
    req = {"c2w": np.asarray(jcams.camera_to_worlds[0]).tolist(),
           "width": 16, "height": 12}
    JaxViewer(jpipe, port=0)._render(req)
    ViewerServer(tpipe, port=0)._render(req)
    assert jpipe.steps[-1] == 0 and tpipe.steps[-1] == 43


def test_tsdf_depth_unlike_jax(tmp_path):
    """A reference-side trait: the JAX script hands ``export_tsdf_mesh``
    the pipeline's ``render_camera`` (scripts/exporter.py:80-83), whose
    depth is the ray's length over ``scale_factor`` (10 for every gf-nerf
    method but gf-nerf-tiny), while ``integrate_tsdf`` reads camera z in
    world units: nearly every voxel lies behind the surface it is given,
    and its mesh of the unit sphere lies at a median 2.1 from the centre,
    in the box's corners nearest the cameras.  The port's
    render function (``export.camera_z_render_fn``) turns the same render
    into camera z: its mesh hugs the sphere, with the vertices of the one
    fused from exact camera-z depth."""
    from gfnerf_tpu.exporter.exporter import export_tsdf_mesh as jax_tsdf
    from gfnerf_tpu_torch.export import camera_z_render_fn
    from gfnerf_tpu_torch.exporter.exporter import export_tsdf_mesh

    jcams, tcams = _ring_cams(8, (48, 36), 45.0)
    aabb = np.array([[-1.6] * 3, [1.6] * 3])
    jpipe, tpipe = _StubPipeline(True, jcams), _StubPipeline(False, tcams)

    def jax_render(cams, i, downscale=1):   # the JAX script's argument
        return jpipe.render_camera(cams, i, step=0, downscale=downscale)

    def verts(path):
        return np.array([[float(x) for x in line.split()[1:]]
                         for line in path.read_text().splitlines()
                         if line.startswith("v ")]).reshape(-1, 3)

    jax_tsdf(jax_render, jcams, aabb, 24, tmp_path / "j.obj", downscale=2)
    assert np.median(np.linalg.norm(verts(tmp_path / "j.obj"), axis=-1)) \
        > 1.9
    n = export_tsdf_mesh(camera_z_render_fn(tpipe, tcams), tcams, aabb, 24,
                         tmp_path / "t.obj", downscale=2)
    export_tsdf_mesh(_sphere_render, tcams, aabb, 24, tmp_path / "z.obj",
                     downscale=2)
    got = verts(tmp_path / "t.obj")
    assert n == len(got) > 50
    assert abs(np.median(np.linalg.norm(got, axis=-1)) - 1.0) < 0.1
    np.testing.assert_array_equal(got, verts(tmp_path / "z.obj"))


# ---- the entry point on a CPU run ----


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A gf-nerf-tiny CPU run into its focal stage: its directory."""
    from gfnerf_tpu_torch import train
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    tmp = tmp_path_factory.mktemp("export_run")
    scene = make_synthetic_npz(tmp / "scene", n_train=12, n_val=2,
                               img_wh=(32, 24))
    assert train.main([
        "gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
        "--output-dir", str(tmp / "out"), "--experiment-name", "tiny",
        "--max-num-iterations", "12",
        "pipeline.datamanager.train_num_rays_per_batch=128",
        "pipeline.model.s3im_patch_height=8"]) == 0
    (config,) = (tmp / "out").glob("tiny/gf-nerf-tiny/*/config.json")
    return config.parent


def test_export_every_mode(run_dir, tmp_path):
    """``python -m gfnerf_tpu_torch.export`` in its five modes on the run:
    each file parses back with finite values; the poses are the train
    cameras; the textured mesh has the density mesh's vertices."""
    from gfnerf_tpu_torch import export
    from gfnerf_tpu_torch.utils.image_io import read_png

    out = tmp_path / "exports"
    base = ["--load-config", str(run_dir / "config.json"),
            "--output-dir", str(out)]
    assert export.main(["pointcloud", *base, "--num-views", "4",
                        "--downscale-factor", "2"]) == 0
    data = (out / "point_cloud.ply").read_bytes()
    n = int(data.split(b"element vertex ")[1].split(b"\n")[0])
    pts = np.frombuffer(data[data.index(b"end_header\n") + 11:],
                        np.dtype([("p", "<f4", (3,)), ("c", "u1", (3,))]))
    assert n == len(pts) > 0 and np.isfinite(pts["p"]).all()

    assert export.main(["poses", *base]) == 0
    frames = json.loads((out / "camera_poses.json").read_text())
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup

    _, trainer = eval_setup(run_dir / "config.json")
    cams = trainer.pipeline.datamanager.train_dataparser_outputs.cameras
    assert len(frames) == len(cams) == 12
    np.testing.assert_array_equal(
        np.array([f["transform"] for f in frames])[:, :3],
        cams.camera_to_worlds)

    # the untrained-ish field: a threshold its density reaches
    assert export.main(["mesh", *base, "--resolution", "24",
                        "--density-threshold", "1.0"]) == 0
    assert export.main(["tsdf", *base, "--resolution", "20",
                        "--num-views", "4", "--downscale-factor", "2"]) == 0
    meshes = {}
    for name in ("mesh.obj", "tsdf_mesh.obj"):
        lines = (out / name).read_text().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                      if ln.startswith("v ")]).reshape(-1, 3)
        assert len(v) > 0 and np.isfinite(v).all(), name
        meshes[name] = v
    # gf-nerf-tiny's root cube is [-4, 4]^3: the mesh's box stays inside
    tree = trainer.pipeline.sampler.tree
    assert float(tree.side_lens[0]) == 8.0
    assert np.abs(meshes["mesh.obj"]).max() <= 4.0
    assert np.abs(meshes["tsdf_mesh.obj"]).max() <= 4.0
    assert export.main(["texture", *base]) == 0
    tex = read_png(out / "texture.png")
    text = (out / "mesh.obj").read_text()
    assert text.startswith("mtllib material.mtl")
    assert text.count("\nv ") == len(meshes["mesh.obj"])
    n_faces = text.count("\nf ")
    cols = int(np.ceil(np.sqrt(n_faces)))
    assert tex.shape == (int(np.ceil(n_faces / cols)) * 8, cols * 8, 3)


def test_export_on_a_vanilla_run(tmp_path):
    """A nerfacto CPU run: the TSDF and the point cloud export through the
    vanilla pipeline's render, the texture through its ``render_rays``;
    the density mesh, which locates points in an octree, is refused."""
    from gfnerf_tpu_torch import export, train
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = make_synthetic_npz(tmp_path / "scene", n_train=8, n_val=2,
                               img_wh=(24, 16))
    assert train.main([
        "nerfacto", "--data", str(scene), "--device", "cpu",
        "--output-dir", str(tmp_path / "out"), "--experiment-name", "n",
        "--max-num-iterations", "3",
        "pipeline.train_num_rays_per_batch=64",
        "pipeline.nerfacto.num_proposal_samples=16,8",
        "pipeline.nerfacto.num_nerf_samples=8",
        "pipeline.nerfacto.log2_hashmap_size=10"]) == 0
    (config,) = (tmp_path / "out").glob("n/nerfacto/*/config.json")
    out = tmp_path / "exports"
    base = ["--load-config", str(config), "--output-dir", str(out)]
    with pytest.raises(SystemExit, match="octree"):
        export.main(["mesh", *base])
    assert export.main(["pointcloud", *base, "--num-views", "2",
                        "--downscale-factor", "2"]) == 0
    assert export.main(["tsdf", *base, "--resolution", "12",
                        "--num-views", "2", "--downscale-factor", "2"]) == 0
    from gfnerf_tpu_torch.exporter.exporter import export_marching_cubes_mesh

    export_marching_cubes_mesh(_density, np.array([[-1.5] * 3, [1.5] * 3],
                                                  np.float32), 8, 5.0,
                               out / "mesh.obj")
    assert export.main(["texture", *base]) == 0
    assert (out / "texture.png").is_file()


# ---- plots ----


def test_plots_match_jax(tmp_path):
    """``vis_rays_obj`` and ``vis_samples_ply``: the JAX text;
    ``vis_march_debug`` on the tiny octree: the same ray file, counts and
    sample file."""
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JaxSampler
    from gfnerf_tpu.utils import plots as J
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from gfnerf_tpu_torch.utils import plots as T

    rng = np.random.default_rng(0)
    o = rng.standard_normal((300, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    assert T.vis_rays_obj(o, d, tmp_path / "t.obj") == \
        J.vis_rays_obj(o, d, tmp_path / "j.obj") == 256
    assert (tmp_path / "t.obj").read_text() == \
        (tmp_path / "j.obj").read_text()
    pts = rng.standard_normal((500, 3))
    vals = rng.random(500)
    valid = rng.random(500) > 0.3
    assert T.vis_samples_ply(pts, vals, valid, tmp_path / "t.ply", 200) == \
        J.vis_samples_ply(pts, vals, valid, tmp_path / "j.ply", 200) == 200
    assert (tmp_path / "t.ply").read_text() == \
        (tmp_path / "j.ply").read_text()

    joct, toct = octree_pair()
    ro, rd = tiny_rays(32)
    kw = dict(max_samples=64, sample_l=1.0 / 16, max_hits=64,
              locate_iters=14)
    want = J.vis_march_debug(joct, ro, rd, JaxSampler(**kw), tmp_path / "j")
    got = T.vis_march_debug(toct, ro, rd, SamplerConfig(**kw),
                            tmp_path / "t")
    assert got == want and got["points"] > 0
    for name in ("rays.obj", "samples.ply"):
        tl = (tmp_path / "t" / name).read_text().splitlines()
        jl = (tmp_path / "j" / name).read_text().splitlines()
        assert len(tl) == len(jl), name
        if name == "rays.obj":
            assert tl == jl
        else:
            tv = np.array([[float(x) for x in ln.split()] for ln in tl[10:]])
            jv = np.array([[float(x) for x in ln.split()] for ln in jl[10:]])
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
