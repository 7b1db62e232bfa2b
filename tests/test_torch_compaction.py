"""Per-ray budget compaction in the port's ``model_forward`` against the JAX
package's (``gfnerf_tpu/models/gfnerf.py:194-284``), with the oracle
cases of tests/test_compaction.py (every ray keeps its own first
``budget`` valid samples, also when the batch's valid samples exceed
R * budget and when validity is ragged), the compacted branch in both hash
layouts at both stages, with and without the empty-space penalty's shared
density, the routed (block per ray) compacted branch, the sync-free index
against ``nonzero``, and one whole train step with budget < S.

Both packages get the same samples (numpy) and warp them from the world
points (the fast march's deferred warp), so only the compaction, the field
and the composite are compared.

Tolerances are those of tests/test_torch_render.py and
tests/test_torch_train.py for the same layout and dtype (f32 MLPs): render
outputs rtol 1e-5, atol 1e-5; a train step's losses rtol 1e-5, its
per-ray error 1e-5, its gradients those of test_torch_train.py (MLPs 1e-3
of the group's largest, the packed table 2e-2).  The block stage's
densities, which the empty-space penalty reads, to 2e-4 of their scale:
the tolerance tests/test_torch_hash_encoding.py gives the residual graph
(two encodes) as it is; on these samples the dense branch differs from
the JAX package's by the same 1.0e-4-1.5e-4 on densities of about 3, at
the same points.
"""

import numpy as np
import pytest
import torch

from torch_parity import (TRAIN_S, field_pair, jax_groups, jax_samples,
                          jax_train_step, marched_np, octree_pair,
                          port_samples, port_train_step, samples_np, to_np,
                          train_batch)

RTOL = ATOL = 1e-5
# the block stage's densities (the residual graph's two encodes):
# tests/test_torch_hash_encoding.py's 2e-4 of their scale
DENSITY_TOL = 2e-4
KEYS = ("rgb", "accumulation", "depth", "weights", "alphas")
ANCHORED = dict(hash_layout="anchored", log2_hashmap_size=10, num_levels=4,
                features_per_level=2)
LAYOUTS = {"packed": {}, "anchored": ANCHORED}


def _forward_both(x, dirs, budget, layout="packed", stage=0, penalty=0.0,
                  routed=None, active_block=1, **field_over):
    """model_forward of both packages on the same samples: (JAX outputs,
    the port's outputs), numpy."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import model_forward as jax_forward
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                model_forward)

    joct, toct = octree_pair()
    jcfg, params, statics, field = field_pair(
        block_scale=0.3, mlp_dtype="float32", **LAYOUTS[layout],
        **field_over)
    r = x["valid"].shape[0]
    rel = np.arange(r) % 6
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=budget,
               empty_space_penalty_mult=penalty)
    jmodel = JModel(n_blocks=2, **mkw)
    # jitted, as the JAX render and train paths run it
    want = jax.jit(lambda p, st, smp, d, rl, oct_dev, blk: jax_forward(
        p, st, jcfg, jmodel, smp, d, rl, stage, active_block,
        oct_dev=oct_dev, warp_deferred=True, routed_blocks=blk))(
            params, statics, jax_samples(x), jnp.asarray(dirs),
            jnp.asarray(rel, jnp.int32), joct,
            None if routed is None else jnp.asarray(routed, jnp.int32))
    with torch.no_grad():
        got = model_forward(
            field, GFNeRFModelConfig(**mkw), port_samples(x),
            torch.as_tensor(dirs), torch.as_tensor(rel), stage, toct,
            active_block,
            routed_blocks=None if routed is None else torch.as_tensor(routed))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: to_np(v) for k, v in got.items()})


def _assert_match(want, got, keys=KEYS):
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _ray_dirs(r, seed=1):
    d = np.random.default_rng(seed).standard_normal((r, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("layout", ["packed", "anchored"])
def test_budget_cap_is_per_ray(layout):
    """Every ray fully valid: 8 * 32 = 256 valid samples against r * budget
    = 64 slots.  Each ray keeps exactly its first ``budget`` samples (the
    last ray is not starved), as in the JAX package."""
    r, s, budget = 8, 32, 8
    x = samples_np(np.ones((r, s), bool), n_volumes=4)
    want, got = _forward_both(x, _ray_dirs(r), budget, layout)
    _assert_match(want, got)
    for i in range(r):
        assert got["alphas"][i, :budget].max() > 0, f"ray {i} lost samples"
        assert np.all(got["alphas"][i, budget:] == 0), (
            f"ray {i} evaluated beyond its budget")


@pytest.mark.parametrize("layout", ["packed", "anchored"])
def test_budget_cap_respects_validity_prefix(layout):
    """Ragged validity: a ray with fewer valid samples than the budget,
    one whose valid samples start late, a full one and an empty one keep
    their first ``budget`` VALID samples."""
    r, s, budget = 4, 16, 4
    valid = np.zeros((r, s), bool)
    valid[0, :2] = True
    valid[1, 4:12] = True
    valid[2, :] = True
    x = samples_np(valid, n_volumes=4)
    want, got = _forward_both(x, _ray_dirs(r), budget, layout)
    _assert_match(want, got)
    alphas = got["alphas"]
    assert alphas[0, :2].max() > 0 and np.all(alphas[0, 2:] == 0)
    assert alphas[1, 4:8].max() > 0 and np.all(alphas[1, 8:] == 0)
    assert np.all(alphas[1, :4] == 0)
    assert alphas[2, :budget].max() > 0 and np.all(alphas[2, budget:] == 0)
    assert np.all(alphas[3] == 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_indices_match_nonzero(seed):
    """The sync-free index equals ``nonzero`` of the capped mask, padded
    with R * S to R * budget (``jnp.nonzero(..., size=k, fill_value)``)."""
    from gfnerf_tpu_torch.models.gfnerf import compact_indices

    rng = np.random.default_rng(seed)
    r, s, budget = 24, 40, 7
    valid = rng.random((r, s)) < rng.uniform(0.05, 0.9, (r, 1))
    valid[3] = False
    valid[5] = True
    keep = valid & (np.cumsum(valid, axis=1) <= budget)
    want = np.full(r * budget, r * s)
    nz = np.nonzero(keep.reshape(-1))[0]
    want[:len(nz)] = nz
    got = compact_indices(torch.as_tensor(valid), budget)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout,stage,penalty",
                         [("packed", 0, 0.0), ("packed", 1, 0.0),
                          ("packed", 1, 0.1), ("anchored", 0, 0.0),
                          ("anchored", 1, 0.0), ("anchored", 1, 0.1)])
def test_compacted_forward_matches_jax(layout, stage, penalty):
    """The compacted branch on a march of the tiny scene (S = 64 slots,
    budget 16: most rays hold more valid samples than that), at the init
    and the block stage (residual, block 1), the block stage also with
    the empty-space penalty's shared density (both densities compared)."""
    x, dirs = marched_np()
    assert (x["valid"].sum(1) > 16).mean() > 0.5
    want, got = _forward_both(x, dirs, 16, layout, stage, penalty)
    assert want["accumulation"].max() > 0.3
    _assert_match(want, got)
    if penalty:
        for k in ("density", "density_shared"):
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=DENSITY_TOL,
                                       atol=DENSITY_TOL * scale, err_msg=k)
        assert np.abs(want["density"] - want["density_shared"]).max() > 1e-4
    else:
        assert "density" not in got


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_compacted_routed_matches_jax(focal_mode):
    """The routed compacted branch (packed layout, eval): each kept sample
    reads its ray's block, the pad slots carry anchor -1 and block -1 and
    are dropped; a ray of block -1 renders from the global table alone
    (residual) or not at all (finetune), as in the JAX package."""
    x, dirs = marched_np()
    r = x["valid"].shape[0]
    blocks = np.arange(r) % 2
    blocks[5] = -1
    want, got = _forward_both(x, dirs, 16, "packed", 1, routed=blocks,
                              focal_mode=focal_mode)
    assert want["accumulation"].max() > 0.3
    _assert_match(want, got)


def test_compacted_train_step_matches_jax():
    """One init-stage train step with budget 16 < S = 64 (the compacted
    branch), against the JAX step from the same parameters, batch, noise
    and permutations: losses to rtol 1e-5, the per-ray error to 1e-5, the
    MLP and appearance gradients to 1e-3 of the group's largest and the
    table gradient to 2e-2 of its largest (test_torch_train.py's); the
    updated parameters to 1e-5 where the gradient is sure; the occupancy
    statistics equal."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    joct, toct = octree_pair()
    batch = train_batch(2)
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=16)
    (jstate, jo, jm, jerr), noise, perms = jax_train_step(
        jcfg, params, statics, joct, batch, mkw, key_seed=9)
    state, to, tm, terr = port_train_step(field, toct, batch, mkw, noise,
                                          perms)
    assert float(jm["num_samples_per_ray"]) > 16
    assert TRAIN_S > 16
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr",
              "num_samples_per_ray"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-5)
    inner = jstate.opt_state.inner_state.inner_states
    groups = field_param_groups(field)
    jp = jax_groups(jstate.params)
    for name, tol in (("fields", 1e-3), ("base_encoding_init", 2e-2)):
        jg = [np.asarray(m) / 0.1 for m in
              jax_groups(inner[name].inner_state[0].mu[0])[name]]
        scale = max(float(np.abs(g).max()) for g in jg)
        assert scale > 0
        for i, (p, want, g) in enumerate(zip(groups[name], jp[name], jg)):
            np.testing.assert_allclose(to_np(p.grad), g, rtol=tol,
                                       atol=tol * scale,
                                       err_msg=f"{name}[{i}] grad")
            sure = np.abs(g) > 2 * tol * scale
            np.testing.assert_allclose(to_np(p)[sure],
                                       np.asarray(want)[sure], rtol=0,
                                       atol=1e-5, err_msg=f"{name}[{i}]")
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(to_np(getattr(to, k)),
                                      np.asarray(getattr(jo, k)), err_msg=k)
    assert state.step == 1


def test_colour_heads_match_jax():
    """The per-point colour head (``field_rgb``) and the compacted one
    (``field_rgb_compact``: the per-ray first-layer part gathered to each
    sample's ray) against the JAX package's, f32 MLPs, rtol 1e-5, atol
    1e-5."""
    import jax.numpy as jnp
    from gfnerf_tpu.fields import field as J
    from gfnerf_tpu_torch.fields import field as T

    jcfg, params, _, field = field_pair(mlp_dtype="float32")
    rng = np.random.default_rng(5)
    r, k = 12, 40
    dirs = rng.standard_normal((k, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    geo = rng.standard_normal((k, jcfg.geo_feat_dim)).astype(np.float32)
    rel = rng.integers(0, jcfg.num_images, k)
    ray_k = rng.integers(0, r, k)
    want = J.field_rgb(params, jcfg, jnp.asarray(dirs), jnp.asarray(geo),
                       jnp.asarray(rel, jnp.int32), 0)["rgb"]
    with torch.no_grad():
        got = T.field_rgb(field, torch.as_tensor(dirs), torch.as_tensor(geo),
                          torch.as_tensor(rel))["rgb"]
        pre = T._head_ray_pre(field, torch.as_tensor(dirs[:r]),
                              torch.as_tensor(rel[:r]))
        compact = T.field_rgb_compact(field, pre, torch.as_tensor(geo),
                                      torch.as_tensor(ray_k))["rgb"]
    jpre = J._head_ray_pre(params, jcfg, jnp.asarray(dirs[:r]),
                           jnp.asarray(rel[:r], jnp.int32))
    jcompact = J.field_rgb_compact(params, jcfg, jpre, jnp.asarray(geo),
                                   jnp.asarray(ray_k, jnp.int32))["rgb"]
    assert got.shape == (k, 3) and compact.shape == (k, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(compact.numpy(), np.asarray(jcompact),
                               rtol=RTOL, atol=ATOL)


def test_pads_spread_over_rays():
    """With few valid samples (a coarse march) most of the R * budget
    places are pads; each ray index then appears at most 2 * budget times
    in ``ray_k`` (its kept samples and its share of the pads), so the
    colour head gather's backward, which serializes equal indices, stays
    as cheap as with a full buffer.  The kept places keep their own ray."""
    from gfnerf_tpu_torch.fields.field import FieldConfig
    from gfnerf_tpu_torch.models.gfnerf import compact_samples

    r, s, budget = 16, 32, 8
    valid = np.zeros((r, s), bool)
    valid[:, 5] = True
    valid[3, :] = True
    _, toct = octree_pair()
    x = samples_np(valid, toct.w2xz.shape[0])
    idx, anc, ray, _ = compact_samples(port_samples(x), budget, toct,
                                       FieldConfig())
    kept = idx < r * s
    assert int(kept.sum()) == r - 1 + budget
    np.testing.assert_array_equal(ray[kept].numpy(),
                                  (idx[kept] // s).numpy())
    assert bool((anc[~kept] == -1).all())
    assert int(torch.bincount(ray, minlength=r).max()) <= 2 * budget
