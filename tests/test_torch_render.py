"""The ported render slice against the JAX package's ``make_render_fn`` on
the tiny scene, ray generation, and the port's independence from JAX.

Tolerances: f32 MLPs 1e-5 absolute on outputs of order 1 (the same samples,
the same hash rows, f32 sums in other orders).  bf16 MLPs 2e-3: a hidden
activation can round to a neighbouring bf16 value in one package and not the
other (see tests/test_torch_field.py), which moves a ray's colour by about
1e-4 after compositing; the bound leaves a tenfold margin.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import field_pair, octree_pair, tiny_rays

REPO = Path(__file__).resolve().parent.parent
ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
KEYS = ("rgb", "accumulation", "depth", "oct_depth")


def _cameras_np(n=4, w=20, h=15):
    from tests.conftest import make_ring_cameras

    c2w, intri = make_ring_cameras(n, img_wh=(w, h))
    return c2w, intri[:, 0, 0], intri[:, 1, 1], intri[:, 0, 2], intri[:, 1, 2]


def test_generate_rays_match():
    import jax.numpy as jnp
    from gfnerf_tpu.cameras import cameras as J
    from gfnerf_tpu_torch.cameras import cameras as T

    c2w, fx, fy, cx, cy = _cameras_np()
    w, h = 20, 15
    jc = J.Cameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(fx),
                   fy=jnp.asarray(fy), cx=jnp.asarray(cx), cy=jnp.asarray(cy),
                   width=jnp.full(4, w, jnp.int32),
                   height=jnp.full(4, h, jnp.int32))
    tc = T.Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device="cpu")
    coords = T.get_image_coords(h, w)
    np.testing.assert_array_equal(coords, J.get_image_coords(h, w))

    want = J.generate_rays(jc, 2, jnp.asarray(coords))
    got = T.generate_rays(tc, 2, torch.as_tensor(coords))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    rng = np.random.default_rng(0)
    idx = rng.integers(0, 4, 128).astype(np.int32)
    pix = (rng.random((128, 2)) * [h, w]).astype(np.float32)
    want = J.generate_rays_multi(jc, jnp.asarray(idx), jnp.asarray(pix))
    got = T.generate_rays_multi(tc, torch.as_tensor(idx).long(),
                                torch.as_tensor(pix))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mlp_dtype,background",
                         [("float32", "black"), ("bfloat16", "white"),
                          ("float32", "last_sample")])
def test_render_chunk_matches_jax(mlp_dtype, background):
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import make_render_fn as jax_render_fn
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JSampler
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct = octree_pair()
    jcfg, params, statics, field = field_pair(mlp_dtype=mlp_dtype)
    s = 64
    mkw = dict(scale_factor=2.0, samples_budget_per_ray=s,
               background_color=background)
    skw = dict(max_samples=s, sample_l=1.0 / 64)
    o, d = tiny_rays(n_rays=128)
    want = jax_render_fn(jcfg, JModel(n_blocks=2, **mkw), JSampler(**skw))(
        params, statics, joct, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(3, jnp.int32), jnp.asarray(0, jnp.int32), False)
    got = make_render_fn(GFNeRFModelConfig(**mkw), SamplerConfig(**skw))(
        field, toct, torch.as_tensor(o), torch.as_tensor(d), 3)
    assert float(np.asarray(want["accumulation"]).max()) > 0.3
    for k in KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=ATOL[mlp_dtype], err_msg=k)


def test_compaction_and_focal_render_raise():
    """What the render refuses: a focal render whose block vector does not
    match the chunk's rays.  Per-ray budget compaction, which it refused
    before it was ported, now renders at either stage as the JAX package's
    make_render_fn does (f32 tolerance above; tests/test_torch_compaction.py
    holds the branch in full)."""
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import make_render_fn as jax_render_fn
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JSampler
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct = octree_pair()
    jcfg, params, statics, field = field_pair(block_scale=0.3)
    o_np, d_np = tiny_rays(n_rays=8)
    o, d = torch.as_tensor(o_np), torch.as_tensor(d_np)
    skw = dict(max_samples=32, sample_l=1.0 / 64)
    scfg = SamplerConfig(**skw)
    compact = make_render_fn(GFNeRFModelConfig(samples_budget_per_ray=16),
                             scfg)
    jax_compact = jax_render_fn(jcfg, JModel(n_blocks=2,
                                             samples_budget_per_ray=16),
                                JSampler(**skw))
    for block in (False, True):
        got = compact(field, toct, o, d, 0, 1, stage_is_block=block)
        want = jax_compact(params, statics, joct, jnp.asarray(o_np),
                           jnp.asarray(d_np), jnp.asarray(0, jnp.int32),
                           jnp.asarray(1, jnp.int32), block)
        for k in KEYS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=ATOL["float32"],
                                       err_msg=f"{k} block={block}")
    dense = make_render_fn(GFNeRFModelConfig(samples_budget_per_ray=0), scfg)
    with pytest.raises(ValueError):
        dense(field, toct, o, d, 0, torch.zeros(5, dtype=torch.int64),
              stage_is_block=True)


JAX_FREE_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax", "gfnerf_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import gfnerf_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        gfnerf_tpu_torch.__path__, "gfnerf_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from gfnerf_tpu_torch.fields.field import (FieldConfig, GFNeRFField,
                                               init_field_params)
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.sampler.octree import build_octree
    from gfnerf_tpu_torch.sampler.perssampler import (SamplerConfig,
                                                      octree_to_device)
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras

    c2w, fx, fy, cx, cy, w, h = ring_cameras(6, img_wh=(32, 24))
    intri = np.zeros((6, 3, 3), np.float32)
    intri[:, 0, 0], intri[:, 1, 1] = fx, fy
    intri[:, 0, 2], intri[:, 1, 2], intri[:, 2, 2] = cx, cy, 1
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (6, 1))
    tree = build_octree(c2w, intri, bounds, max_depth=5, bbox_levels=3,
                        n_rand_pts=512, vis_res_w=16, seed=0, device="cpu")
    cfg = FieldConfig(num_images=6, n_volumes=tree.n_volumes, num_levels=4,
                      features_per_level=4, hash_layout="packed",
                      packed_rows_log2=10, n_blocks=2, hidden_dim=32,
                      hidden_dim_color=32, mlp_dtype="bfloat16")
    field = GFNeRFField(cfg, *init_field_params(cfg, seed=0), device="cpu")
    render = make_render_fn(
        GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=64),
        SamplerConfig(max_samples=64, sample_l=1.0 / 64))
    o = torch.as_tensor(np.repeat(c2w[:1, :, 3], 32, axis=0))
    d = -o / o.norm(dim=-1, keepdim=True)
    out = render(field, octree_to_device(tree, 4096, device="cpu"), o, d, 0)
    assert out["rgb"].shape == (32, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "gfnerf_tpu")
                   for m in sys.modules)
    print("JAX_FREE_OK", len(names), float(out["accumulation"].max()))
""")


def test_port_renders_without_jax():
    """A subprocess that refuses every import of jax or gfnerf_tpu imports
    each gfnerf_tpu_torch module and renders one tiny chunk on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", JAX_FREE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout


def test_render_bench_camera_and_frame_chunks():
    """render_bench's chunked renders equal one-pass renders, and its
    sample_l calibration lengthens the step of a march that overfills the
    slot budget (tiny scene, CPU)."""
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.render_bench import (calibrate_sample_l,
                                               frame_rays, render_camera,
                                               render_rays)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, toct = octree_pair()
    field = field_pair()[3]
    c2w, fx, fy, cx, cy = _cameras_np(n=6, w=12, h=9)
    s = 48
    sample_l, med = calibrate_sample_l(toct, c2w, fx, fy, cx, cy, 12, 9, s,
                                       "cpu", n_rays=64)
    assert sample_l > 1.0 / 256 and 0 < med <= s
    render = make_render_fn(GFNeRFModelConfig(samples_budget_per_ray=s),
                            SamplerConfig(max_samples=s, sample_l=sample_l))
    cams = Cameras.from_numpy(c2w, fx, fy, cx, cy, 12, 9, device="cpu")
    chunked = render_camera(render, field, toct, cams, 1, chunk=40)
    whole = render_camera(render, field, toct, cams, 1, chunk=10 ** 6)
    for k in KEYS:
        assert chunked[k].shape[:2] == (9, 12)
        torch.testing.assert_close(chunked[k], whole[k], rtol=0, atol=0)
    o, d = frame_rays(c2w[0], 16, 9, "cpu")
    assert o.shape == d.shape == (144, 3)
    part = render_rays(render, field, toct, o, d, 0, chunk=50)
    full = render(field, toct, o, d, 0)
    for k in KEYS:
        torch.testing.assert_close(part[k], full[k], rtol=0, atol=0)
