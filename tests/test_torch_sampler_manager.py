"""The port's octree maintenance, camera clustering and sampler manager
against the JAX package's, on the CPU.

All of the host side is numpy in both packages, so every comparison is
exact: ``proc_octree`` (compaction, milestone subdivision of visited
leaves, brute force), ``mark_invisible_nodes``, ``update_block_idxs``,
``construct_edge_pool`` and ``octree_from_device`` on
``torch_parity.tiny_tree()``; ``spectral_equal_size_clustering``'s labels;
the manager's calibrated ``max_hits`` and its trees before and after a
milestone rebuild and a compaction.  ``sample_l`` is calibrated by trial
marches on either package's march and agrees to 1e-6 relative.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch_parity
from torch_parity import tiny_cameras, tiny_tree

TREE_KEYS = ("centers", "side_lens", "parents", "childs", "is_leaf",
             "trans_idx", "block_idx", "weight_stats", "alpha_stats",
             "visit_cnt", "w2xz", "weight", "t_center", "t_dis_summary",
             "t_side_len")


def assert_trees_equal(got, want, what=""):
    for k in TREE_KEYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=f"{what}: {k}")


def visited_tree(seed=0):
    """The tiny tree with random visit counts and an invalid leaf, as the
    occupancy statistics leave it."""
    rng = np.random.default_rng(seed)
    tree = tiny_tree()
    visit = rng.integers(0, 9, tree.n_nodes).astype(np.int64)
    trans = tree.trans_idx.copy()
    valid = np.nonzero(trans >= 0)[0]
    trans[valid[rng.choice(len(valid), 3, replace=False)]] = -1
    return dataclasses.replace(tree, visit_cnt=visit, trans_idx=trans)


@pytest.mark.parametrize("compact,subdivide,brute_force",
                         [(True, True, False), (True, False, False),
                          (False, True, True)])
def test_proc_octree_matches_jax(compact, subdivide, brute_force):
    from gfnerf_tpu.sampler.octree import proc_octree as jax_proc
    from gfnerf_tpu_torch.sampler.octree import proc_octree

    tree = visited_tree()
    if not compact:   # subdividing needs every leaf valid
        tree = dataclasses.replace(tree, trans_idx=tiny_tree().trans_idx)
    got = proc_octree(tree, compact, subdivide, brute_force)
    want = jax_proc(tree, compact, subdivide, brute_force)
    assert_trees_equal(got, want)
    if subdivide:
        assert got.n_nodes > tree.n_nodes


def test_visibility_blocks_and_edges_match_jax():
    from gfnerf_tpu.sampler import octree as jax_octree
    from gfnerf_tpu_torch.sampler import octree

    c2w, intri, bounds = tiny_cameras()
    w2c = np.linalg.inv(np.concatenate(
        [c2w, np.tile([[[0, 0, 0, 1]]], (len(c2w), 1, 1))], 1))[:, :3]
    # narrow bounds so that some nodes go unseen
    narrow = np.tile(np.array([[0.01, 2.0]], np.float32), (len(c2w), 1))
    got, want = dataclasses.replace(tiny_tree()), dataclasses.replace(
        tiny_tree())
    got.trans_idx, want.trans_idx = (tiny_tree().trans_idx.copy(),
                                     tiny_tree().trans_idx.copy())
    octree.mark_invisible_nodes(got, c2w, w2c, intri, narrow)
    jax_octree.mark_invisible_nodes(want, c2w, w2c, intri, narrow)
    np.testing.assert_array_equal(got.trans_idx, want.trans_idx)
    assert (got.trans_idx < tiny_tree().trans_idx).any()

    centers = c2w[::2, :, 3]
    octree.update_block_idxs(got, centers)
    jax_octree.update_block_idxs(want, centers)
    np.testing.assert_array_equal(got.block_idx, want.block_idx)
    assert len(np.unique(got.block_idx)) == len(centers)

    octree.construct_edge_pool(got)
    jax_octree.construct_edge_pool(want)
    for k in ("edge_t_idx", "edge_center", "edge_dirs"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert len(got.edge_t_idx) > 0


def test_octree_from_device_matches_jax():
    from gfnerf_tpu.sampler.perssampler import (
        octree_from_device as jax_from_device)
    from gfnerf_tpu_torch.sampler.perssampler import octree_from_device

    joct, toct = torch_parity.octree_pair()
    rng = np.random.default_rng(1)
    toct = dataclasses.replace(
        toct, **{k: toct.visit_cnt.new_tensor(
            rng.integers(-5, 900, toct.visit_cnt.shape[0]))
            for k in ("visit_cnt", "weight_stats", "alpha_stats")})
    toct.trans_idx[:5] = -1
    joct = joct.replace(**{k: np.asarray(getattr(toct, k).numpy())
                           for k in ("visit_cnt", "weight_stats",
                                     "alpha_stats", "trans_idx")})
    assert_trees_equal(octree_from_device(toct, tiny_tree()),
                       jax_from_device(joct, tiny_tree()))


@pytest.mark.parametrize("n,k", [(12, 2), (48, 10)])
def test_clustering_matches_jax(n, k):
    from gfnerf_tpu.sampler.clustering import (
        spectral_equal_size_clustering as jax_cluster)
    from gfnerf_tpu_torch.sampler.clustering import (
        spectral_equal_size_clustering)
    from tests.conftest import make_ring_cameras

    c2w, _ = make_ring_cameras(n)
    pos = c2w[:, :3, 3]
    dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    got = spectral_equal_size_clustering(dist, k, int(n * 0.1), seed=1234)
    np.testing.assert_array_equal(
        got, jax_cluster(dist, k, int(n * 0.1), seed=1234))
    assert np.bincount(got, minlength=k).min() > 0


def manager_pair(**over):
    """(JAX manager, port manager) on the tiny scene, as the pipelines
    build them."""
    from gfnerf_tpu.sampler.manager import PersSamplerManager as JaxManager
    from gfnerf_tpu.sampler.manager import (
        PersSamplerManagerConfig as JaxManagerConfig)
    from gfnerf_tpu_torch.sampler.manager import (PersSamplerManager,
                                                  PersSamplerManagerConfig)

    kw = dict(bbox_levels=3, max_level=5, n_rand_pts=512, vis_res_w=16,
              max_samples=64, sample_l=1.0 / 64, max_hits=2,
              sub_div_milestones=(4, 8), compact_freq=6,
              node_capacity=4096, ray_march_fineness_decay_end_iter=10)
    kw.update(over)
    c2w, intri, bounds = tiny_cameras()
    args = dict(c2w=c2w, intri=intri, bounds=bounds, n_split_dataset=2,
                steps_per_split_dataset=5, steps_perssampler_init=10)
    return (JaxManager(config=JaxManagerConfig(**kw), **args),
            PersSamplerManager(config=PersSamplerManagerConfig(**kw),
                               device="cpu", **args))


def test_manager_calibration_and_rebuilds_match_jax():
    jm, tm = manager_pair()
    assert_trees_equal(tm.tree, jm.tree, "build")
    np.testing.assert_allclose(tm.sampler_config.sample_l,
                               jm.sampler_config.sample_l, rtol=1e-6)
    assert tm.sampler_config.sample_l > 1.0 / 64   # it grew
    assert tm.sampler_config.max_hits == jm.sampler_config.max_hits > 2
    for step in (0, 3, 9, 10, 14):
        assert tm.fineness(step) == jm.fineness(step)
        assert tm.cur_split_idx(step) == jm.cur_split_idx(step)

    # the same occupancy state on both device trees, then the schedule:
    # nothing at step 3, the milestone at 4, compaction at 6
    rng = np.random.default_rng(2)
    cap = tm.oct_dev.visit_cnt.shape[0]
    visit = rng.integers(0, 9, cap).astype(np.int32)
    stats = rng.integers(-3, 900, cap).astype(np.int32)
    trans = tm.oct_dev.trans_idx.numpy().copy()
    trans[np.nonzero(trans >= 0)[0][:2]] = -1
    tm.oct_dev = dataclasses.replace(
        tm.oct_dev, **{k: tm.oct_dev.visit_cnt.new_tensor(v) for k, v in
                       (("visit_cnt", visit), ("weight_stats", stats),
                        ("alpha_stats", stats), ("trans_idx", trans))})
    jm.oct_dev = jm.oct_dev.replace(visit_cnt=visit, weight_stats=stats,
                                    alpha_stats=stats, trans_idx=trans)
    for step in (3, 4, 6):
        rebuilt = tm.maybe_rebuild(step)
        assert rebuilt == jm.maybe_rebuild(step) == (step != 3)
        assert_trees_equal(tm.tree, jm.tree, f"step {step}")
        assert tm.milestones == jm.milestones
        assert tm.sampler_config.max_hits == jm.sampler_config.max_hits
    assert tm.oct_dev.n_nodes == tm.tree.n_nodes

    # clustering, block indices, the eval lookup
    np.testing.assert_array_equal(tm.train_cameras_clustering(2),
                                  jm.train_cameras_clustering(2))
    centers = tm.c2w[::3, :, 3]
    tm.update_block_idxs(centers)
    jm.update_block_idxs(centers)
    np.testing.assert_array_equal(tm.tree.block_idx, jm.tree.block_idx)
    np.testing.assert_array_equal(tm.oct_dev.block_idx.numpy(),
                                  np.asarray(jm.oct_dev.block_idx))
    for origin in tm.c2w[:, :, 3] + 0.1:
        assert (tm.get_nearest_split_dataset(origin)
                == jm.get_nearest_split_dataset(origin))
