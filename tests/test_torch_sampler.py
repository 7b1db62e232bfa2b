"""Parity of the ported octree builder, device upload, warp, fast march and
occupancy update (gfnerf_tpu_torch/sampler/) with the JAX package's, on the
tiny scene of tests/test_render_early.py."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (TREE_KW, asdict_np, octree_pair, tiny_cameras,
                                tiny_rays, tiny_tree, to_np)


@pytest.mark.parametrize("deeper", [False, True])
def test_build_octree_identical(deeper):
    """Every array equal: the tiny tree, and a deeper one from 12 cameras."""
    from gfnerf_tpu.sampler.octree import build_octree as jbuild
    from gfnerf_tpu_torch.sampler.octree import build_octree
    from tests.conftest import make_ring_cameras

    if deeper:
        c2w, intri = make_ring_cameras(12, img_wh=(48, 36))
        bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (12, 1))
        kw = dict(TREE_KW, max_depth=7, bbox_levels=4, vis_res_w=24)
        want = asdict_np(jbuild(c2w, intri, bounds, **kw))
    else:
        c2w, intri, bounds = tiny_cameras()
        kw = TREE_KW
        want = asdict_np(tiny_tree())
    got = asdict_np(build_octree(c2w, intri, bounds, device="cpu", **kw))
    assert got.keys() == want.keys()
    assert len(want["centers"]) > 40 and len(want["w2xz"]) > 4
    for name in want:
        if want[name] is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_octree_to_device_identical():
    joct, toct = octree_pair()
    for f in dataclasses.fields(joct):
        a = np.asarray(getattr(joct, f.name))
        b = to_np(getattr(toct, f.name))
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def _leaf_points(oct_np, n, seed):
    """Points inside random valid leaves, and those leaves' anchors."""
    rng = np.random.default_rng(seed)
    leaves = oct_np["leaf_idx"][oct_np["leaf_idx"] >= 0]
    pick = rng.choice(leaves, n)
    off = rng.uniform(-0.5, 0.5, (n, 3)) * oct_np["side_lens"][pick, None]
    pts = (oct_np["centers"][pick] + off).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    return pts, oct_np["trans_idx"][pick], dirs.astype(np.float32)


def test_warp_points_and_jacobian_match():
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.sampler import perssampler as J
    from gfnerf_tpu_torch.sampler import perssampler as T

    joct, toct = octree_pair()
    pts, trans, dirs = _leaf_points(asdict_np(toct), 2048, seed=0)
    jw = jax.jit(J.warp_points)(joct, jnp.asarray(trans), jnp.asarray(pts))
    tw = T.warp_points(toct, torch.as_tensor(trans).long(),
                       torch.as_tensor(pts))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    jj = jax.jit(J.warp_jacobian_dir)(joct, jnp.asarray(trans),
                                      jnp.asarray(pts), jnp.asarray(dirs))
    tj = T.warp_jacobian_dir(toct, torch.as_tensor(trans).long(),
                             torch.as_tensor(pts), torch.as_tensor(dirs))
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5)


# Tolerated rays whose sample lattice differs: the per-leaf sample count is
# floor((far - near) / step) (fast_march.py:165), and the step comes from
# the warp Jacobian, whose f32 sums XLA contracts into multiply-adds that
# torch rounds separately.  A last-ulp step difference flips that floor for
# a ray whose leaf span sits within an ulp of a whole number of steps.
MAX_FLIPPED_RAY_FRAC = 1e-3


@pytest.mark.parametrize("coarse_hits", [0, 8])
def test_get_samples_fast_matches(coarse_hits):
    import jax.numpy as jnp
    from gfnerf_tpu.sampler.fast_march import get_samples_fast as jmarch
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JCfg
    from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct = octree_pair()
    o, d = tiny_rays(n_rays=1024, seed=11)
    s = 64
    noise = np.random.default_rng(2).uniform(0.5, 1.5, (len(o), s)).astype(
        np.float32)
    kw = dict(max_samples=s, sample_l=1.0 / 64, ray_chunk=256,
              coarse_hits=coarse_hits)
    want = jmarch(joct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(noise),
                  jnp.asarray(1.3, jnp.float32), JCfg(**kw))
    got = get_samples_fast(toct, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(noise), 1.3, SamplerConfig(**kw))
    w = {k: np.asarray(v) for k, v in asdict_np(want).items()
         if v is not None}
    g = {k: v for k, v in asdict_np(got).items() if v is not None}
    assert w["num_valid"].mean() > 10

    ints = ("trans_idx", "oct_idx", "block_idx", "valid", "num_valid")
    same = np.ones(len(o), bool)
    for k in ints:
        same &= (g[k] == w[k]).reshape(len(o), -1).all(axis=1)
    assert (~same).mean() <= MAX_FLIPPED_RAY_FRAC, (~same).sum()
    np.testing.assert_array_equal(g["num_hits"], w["num_hits"])
    np.testing.assert_array_equal(g["first_oct_dis"], w["first_oct_dis"])
    for k in ("ts", "dists", "world_pts"):
        np.testing.assert_allclose(g[k][same], w[k][same], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_oct_nodes_matches_jax(seed):
    """The occupancy update from the same march samples and the same
    weights and alphas: every statistic equal.  Some nodes start with low
    stats so that the trans_idx = -1 path runs."""
    import types

    import jax.numpy as jnp
    from gfnerf_tpu.sampler.fast_march import get_samples_fast as jmarch
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JCfg
    from gfnerf_tpu.sampler.perssampler import update_oct_nodes as jupdate
    from gfnerf_tpu_torch.sampler.perssampler import update_oct_nodes

    joct, toct = octree_pair()
    o, d = tiny_rays(n_rays=256, seed=seed)
    s = 64
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.5, 1.5, (len(o), s)).astype(np.float32)
    samples = jmarch(joct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(noise),
                     jnp.asarray(1.0, jnp.float32),
                     JCfg(max_samples=s, sample_l=1.0 / 64))
    # nodes of odd id see no density: their stats fall
    dense = (np.asarray(samples.oct_idx) % 2 == 0).astype(np.float32)
    w = (rng.random((len(o), s)) ** 4 * 0.2 * dense).astype(np.float32)
    a = (rng.random((len(o), s)) ** 4 * 0.3 * dense).astype(np.float32)
    low = np.asarray(joct.weight_stats).copy()
    low[::3] = 0
    joct = joct.replace(weight_stats=jnp.asarray(low))
    toct = dataclasses.replace(toct, weight_stats=torch.as_tensor(low))
    want = jupdate(joct, samples, jnp.asarray(w), jnp.asarray(a))
    got = update_oct_nodes(
        toct, types.SimpleNamespace(
            valid=torch.as_tensor(np.array(samples.valid)),
            oct_idx=torch.as_tensor(np.array(samples.oct_idx)).long()),
        torch.as_tensor(w), torch.as_tensor(a))
    assert np.asarray(samples.valid).mean() > 0.2
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        g, x = to_np(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.dtype == x.dtype, k
        np.testing.assert_array_equal(g, x, err_msg=k)
    changed = to_np(got.trans_idx) != to_np(toct.trans_idx)
    assert changed.any() and (to_np(got.visit_cnt) > 0).any()


def test_ray_march_fineness_matches_jax():
    from gfnerf_tpu.sampler.perssampler import ray_march_fineness as jf
    from gfnerf_tpu_torch.sampler.perssampler import ray_march_fineness

    for step in (0, 1, 2500, 9999, 10000, 20000):
        assert ray_march_fineness(step) == jf(step)
    assert ray_march_fineness(50, 8.0, 100) == jf(50, 8.0, 100)
