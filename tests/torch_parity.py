"""Shared set-up for the JAX-versus-PyTorch parity tests (tests/test_torch_*).

Builds the tiny scene of tests/test_render_early.py once per process (six
ring cameras, a depth-5 tree), and hands the JAX package and the PyTorch port
the same numpy inputs: the same octree, the same ``init_field_params`` seed,
the same random tables.  Torch runs on the CPU with two threads, because the
suite runs several pytest-xdist workers side by side.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(2)

N_CAMS = 6
IMG_WH = (32, 24)
TREE_KW = dict(max_depth=5, bbox_levels=3, n_rand_pts=512, vis_res_w=16,
               seed=0)


def tiny_cameras():
    """(c2w (6, 3, 4), intri (6, 3, 3), bounds (6, 2)) of the tiny scene."""
    from tests.conftest import make_ring_cameras

    c2w, intri = make_ring_cameras(N_CAMS, img_wh=IMG_WH)
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (N_CAMS, 1))
    return c2w, intri, bounds


@functools.lru_cache(maxsize=1)
def tiny_tree():
    """The tiny scene's octree, built once by the JAX package's builder."""
    from gfnerf_tpu.sampler.octree import build_octree

    c2w, intri, bounds = tiny_cameras()
    return build_octree(c2w, intri, bounds, **TREE_KW)


def octree_pair(capacity: int = 4096):
    """(JAX OctreeDevice, port OctreeDevice) of the same tree."""
    from gfnerf_tpu.sampler.perssampler import octree_to_device as jax_upload
    from gfnerf_tpu_torch.sampler.perssampler import octree_to_device

    tree = tiny_tree()
    return jax_upload(tree, capacity), octree_to_device(tree, capacity,
                                                         device="cpu")


def tiny_rays(n_rays: int = 64, seed: int = 3):
    """Rays from four of the cameras toward the scene, jittered (numpy)."""
    c2w, _, _ = tiny_cameras()
    rng = np.random.default_rng(seed)
    o = np.repeat(c2w[:4, :, 3], n_rays // 4, axis=0).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    o = o + rng.normal(0, 0.05, o.shape).astype(np.float32)
    d = d + rng.normal(0, 0.08, d.shape).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def field_kwargs(**over):
    """FieldConfig arguments of the tiny packed field."""
    kw = dict(num_images=N_CAMS, n_volumes=tiny_tree().n_volumes,
              num_levels=4, features_per_level=4, hash_layout="packed",
              packed_rows_log2=10, n_blocks=2, hidden_dim=32,
              hidden_dim_color=32)
    kw.update(over)
    return kw


def field_pair(seed: int = 0, table_scale: float = 0.5, **over):
    """The same field in both packages.

    Both start from ``init_field_params(seed)``; with ``table_scale`` > 0
    the global table is then replaced, in both, by one numpy draw of
    uniform(-table_scale, table_scale), so renders are not near-constant.
    Returns (jax_cfg, jax_params, jax_statics, port_field).
    """
    import jax.numpy as jnp

    from gfnerf_tpu.fields.field import FieldConfig as JaxFieldConfig
    from gfnerf_tpu.fields.field import init_field_params as jax_init
    from gfnerf_tpu_torch.fields.field import FieldConfig, params_from_jax

    kw = field_kwargs(**over)
    jcfg = JaxFieldConfig(**kw)
    params, statics = jax_init(jcfg, seed=seed)
    if table_scale > 0:
        rng = np.random.default_rng(seed + 100)
        table = rng.uniform(-table_scale, table_scale,
                            params.global_feat.shape).astype(np.float32)
        params = params.replace(global_feat=jnp.asarray(table))
    field = params_from_jax(params, statics, FieldConfig(**kw),
                            device="cpu")
    return jcfg, params, statics, field


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def asdict_np(obj) -> dict:
    """Fields of a dataclass as numpy arrays (None kept)."""
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(to_np(getattr(obj, f.name))))
            for f in dataclasses.fields(obj)}
