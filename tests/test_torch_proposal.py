"""The port's proposal-guided resampling (``gf-nerf-prop``) against the JAX
package's on the CPU: the probe's parameters, ``proposal_density``,
``pdf_sample``, the interlevel and distortion losses, the proposal branch
of ``model_forward`` at both stages, a train step at the init stage and a
focal step after it, the render function, the identity-warp ablation, the
method config, the pipeline's eval routing and early-termination refusal,
and a few pipeline steps against the JAX pipeline.

The forward tests use tests/test_proposal.py's fixture shape: 12 ring
views at 32x24, a depth-5 tree, a packed main field of 4 levels of 2^10
rows, a probe of 3 levels of 2^9 rows (an odd level count), 64 march slots
and 16 fine samples on 32 rays.  The train steps use torch_parity's tiny
scene (6 views, 128 rays, the same field and probe).

Tolerances, and why:
- The probe's starting state and the round trip through
  ``params_from_jax`` / ``to_numpy``: bit for bit.
- ``proposal_density`` (f32 MLP): 1e-5 relative and 1e-5 absolute; bf16:
  test_torch_field's 5e-3.
- ``pdf_sample``: the bins to 1e-5 of the largest t.  XLA:CPU computes the
  weight sum and the CDF's cumulative sum in another association than
  torch (a blocked scan of 16), so the CDF differs by an ulp or two; a
  new bin edge moves by that over the CDF step it falls in.  Measured:
  3.1e-6 on t up to 2.4; no edge changes its CDF bin, and no fine sample
  its marched segment, on these inputs.
- The proposal branch with the bins handed over from JAX (the cumulative
  sums out of the way): 1e-5 absolute on rgb, weights, depth (measured
  8.3e-7, 3.0e-6).  End to end, with each package's own bins: the fine
  anchors equal; the probe's weights to 1e-5 (measured 2.7e-6: its
  cumulative optical depth, the same association difference); the fine
  weights and depth to 5e-5 of their largest (a fine bin's width is a
  difference of two edges that each moved by ~2e-6; measured 1.8e-5 of
  0.16) and rgb to 1e-5 (measured 1.9e-6), on all rays but at most one:
  a fine sample that moved by ~2e-6 can cross a hash cell's edge of the
  block table, which changed one ray of 32 at the block stage by 1.5e-4
  (rgb) and 3.6e-3 (weights) in one of twelve draws; that ray agrees to
  1e-6 when the bins are handed over.  Filed in ROADMAP.md queue 3.
- Losses on the same inputs: 1e-5 relative; their gradients 1e-5 of the
  largest.
- The train step (f32 MLPs): the loss and its parts to 1e-5 relative
  (measured 1.5e-6, the interlevel loss); the MLP gradients (the probe's
  included) to 1e-3 of the group's largest (measured 1.6e-5); the tables'
  (main and probe) at test_torch_train's table tolerance, 2e-2 of their
  largest (the JAX backward rounds its payload to bf16; measured 0.0198
  and 4.5e-4); the occupancy statistics equal.
- The pipeline (gf-nerf-tiny with the probe, 12 steps): see
  test_pipeline_matches_jax_with_proposal.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import TRAIN_S, field_pair, octree_pair, to_np
from torch_pipeline_ref import LOSS_KEYS, PROP_OVERRIDES

N_RAYS, S, K = 32, 64, 16
PROBE = dict(use_proposal=True, proposal_levels=3, proposal_rows_log2=9)
TABLE_TOL = 2e-2
BINS_ATOL_REL = 1e-5


# ---- the fixture scene of tests/test_proposal.py ----


@functools.lru_cache(maxsize=1)
def scene12():
    """(JAX octree, port octree, n_volumes, c2w, rays_o, rays_d) of 12 ring
    views at 32x24 and a depth-5 tree; 32 rays from four cameras."""
    from gfnerf_tpu.sampler.octree import build_octree
    from gfnerf_tpu.sampler.perssampler import octree_to_device as upload
    from gfnerf_tpu.utils.synthetic import ring_cameras
    from gfnerf_tpu_torch.sampler.perssampler import octree_to_device

    c2w, fx, fy, cx, cy, _, _ = ring_cameras(12, img_wh=(32, 24))
    intri = np.zeros((12, 3, 3), np.float32)
    intri[:, 0, 0], intri[:, 1, 1] = fx, fy
    intri[:, 0, 2], intri[:, 1, 2], intri[:, 2, 2] = cx, cy, 1
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (12, 1))
    tree = build_octree(c2w, intri, bounds, max_depth=5, bbox_levels=4,
                        n_rand_pts=512, vis_res_w=16, seed=0)
    rng = np.random.default_rng(7)
    o = np.repeat(c2w[:4, :, 3], 8, axis=0).astype(np.float32)
    d = np.repeat(-c2w[:4, :, 2], 8, axis=0)
    d = d + rng.normal(0, 0.05, d.shape)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (upload(tree, 4096), octree_to_device(tree, 4096, device="cpu"),
            tree.n_volumes, c2w, o, d)


def field12(mlp_dtype="float32", **over):
    """(JAX cfg, params, statics, port field) of the fixture's field: the
    global and probe tables, and the block tables, random (numpy) in both,
    so that neither the field nor the probe is near-constant."""
    import jax.numpy as jnp

    from gfnerf_tpu.fields.field import FieldConfig as JaxFieldConfig
    from gfnerf_tpu.fields.field import init_field_params as jax_init
    from gfnerf_tpu_torch.fields.field import FieldConfig, params_from_jax

    kw = dict(num_images=12, n_volumes=scene12()[2], num_levels=4,
              features_per_level=4, hash_layout="packed",
              packed_rows_log2=10, n_blocks=2, hidden_dim=32,
              hidden_dim_color=32, mlp_dtype=mlp_dtype, **PROBE)
    kw.update(over)
    params, statics = jax_init(JaxFieldConfig(**kw), seed=0)
    rng = np.random.default_rng(100)

    def draw(x, scale):
        return jnp.asarray(rng.uniform(-scale, scale, x.shape)
                           .astype(np.float32))

    params = params.replace(global_feat=draw(params.global_feat, 0.5),
                            prop_feat=draw(params.prop_feat, 0.5),
                            block_feats=draw(params.block_feats, 0.2))
    return (JaxFieldConfig(**kw), params, statics,
            params_from_jax(params, statics, FieldConfig(**kw),
                            device="cpu"))


@functools.lru_cache(maxsize=1)
def marched12():
    """The port's march of the fixture's rays at fineness 2, as numpy."""
    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, toct, _, _, o, d = scene12()
    smp = sample_rays(toct, torch.as_tensor(o), torch.as_tensor(d),
                      torch.ones((N_RAYS, S)), 2.0,
                      SamplerConfig(max_samples=S, sample_l=1.0 / 64))
    return {k: to_np(getattr(smp, k)) for k in
            ("world_pts", "dists", "ts", "trans_idx", "valid",
             "first_oct_dis")}


def jax_jitter(seed):
    """Uniform draws (32, K + 1) from a JAX key, as the JAX step draws its
    resampling's (None for seed None: eval)."""
    import jax

    if seed is None:
        return None, None
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.uniform(key, (N_RAYS, K + 1)))


def sorted_lattice(x):
    """The proposal branch's sort of the marched samples, in numpy: (the
    order, anchors, validity) of each ray's t-sorted samples."""
    order = np.argsort(np.where(x["valid"], x["ts"], np.inf), axis=1,
                       kind="stable")
    return (order, np.take_along_axis(x["trans_idx"], order, 1),
            np.take_along_axis(x["valid"], order, 1))


def jax_fine_anchors(x, out):
    """The fine anchors of a JAX proposal forward's outputs, reckoned as
    _model_forward_proposal does (the JAX package does not return them)."""
    _, anc_m, valid_m = sorted_lattice(x)
    ts_fix = np.asarray(out["prop_spacing"][0])
    bs, be = (np.asarray(t) for t in out["fine_spacing"])
    t_f = (bs + be) / 2.0
    seg = np.clip((t_f[:, :, None] >= ts_fix[:, None, :]).sum(-1) - 1, 0,
                  ts_fix.shape[1] - 1)
    return np.where(np.take_along_axis(valid_m, seg, 1),
                    np.take_along_axis(anc_m, seg, 1), -1)


# ---- the probe's parameters ----


@pytest.mark.parametrize("layout", ["packed", "anchored"])
def test_probe_init_matches_jax(layout):
    """init_field_params(use_proposal=True) draws the probe after the
    appearance embedding, bit for bit as the JAX package does, and
    params_from_jax / to_numpy carry it both ways."""
    from gfnerf_tpu.fields.field import FieldConfig as JaxFieldConfig
    from gfnerf_tpu.fields.field import init_field_params as jax_init
    from gfnerf_tpu_torch.fields.field import (FieldConfig,
                                               init_field_params,
                                               params_from_jax)

    kw = tp.field_kwargs(hash_layout=layout, **PROBE)
    jp, js = jax_init(JaxFieldConfig(**kw), seed=3)
    tp_, ts = init_field_params(FieldConfig(**kw), seed=3)
    assert tp_.prop_feat.shape == (3, 1 << 9, 128)
    assert [w.shape for w in tp_.prop_net["w"]] == [(12, 16), (16, 1)]
    for got, want in ((tp_, jp), (ts, js)):
        for f in dataclasses.fields(got):
            name, g, w = f.name, getattr(got, f.name), getattr(want, f.name)
            if isinstance(g, dict):
                for part in ("w", "b"):
                    for a, b in zip(g[part], w[part]):
                        np.testing.assert_array_equal(a, np.asarray(b))
            elif g is not None:
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=name)
    field = params_from_jax(jp, js, FieldConfig(**kw), device="cpu")
    assert field.prop_feat.requires_grad
    assert "prop_prim" in dict(field.named_buffers())
    bp, bs = field.to_numpy()
    np.testing.assert_array_equal(bp.prop_feat, np.asarray(jp.prop_feat))
    for part in ("w", "b"):
        for a, b in zip(bp.prop_net[part], jp.prop_net[part]):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(bs.prop_prim, np.asarray(js.prop_prim))
    assert bs.prop_prim.dtype == np.uint32
    np.testing.assert_array_equal(bs.prop_bias, np.asarray(js.prop_bias))


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_proposal_density_matches_jax(mlp_dtype):
    """The probe's density on marched, warped points, masked anchors
    included."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.field import proposal_density as jax_density
    from gfnerf_tpu_torch.fields.field import proposal_density
    from gfnerf_tpu_torch.sampler.perssampler import warp_points

    jcfg, params, statics, field = field12(mlp_dtype)
    toct = scene12()[1]
    x = marched12()
    anc = torch.as_tensor(x["trans_idx"]).long()
    warp = warp_points(toct, anc.reshape(-1).clamp(0),
                       torch.as_tensor(x["world_pts"]).reshape(-1, 3)
                       ).reshape(N_RAYS, S, 3)
    got = to_np(proposal_density(field, warp, anc))
    want = np.asarray(jax.jit(lambda p, w, a: jax_density(
        p, statics, jcfg, w, a))(params, jnp.asarray(to_np(warp)),
                                 jnp.asarray(x["trans_idx"], jnp.int32)))
    assert got.shape == (N_RAYS, S) and (got[x["trans_idx"] < 0] == 0).all()
    assert want.max() > 2 * want[want > 0].min()   # not near-constant
    tol = 1e-5 if mlp_dtype == "float32" else 5e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---- the resampler and the losses ----


def histogram(kind, seed=0):
    """(starts, ends, weights) (32, 64) numpy: the fixture's marched lattice
    as the proposal branch makes it (sorted, monotone, contiguous), with
    random, all-zero or one-hot weights."""
    x = marched12()
    order, _, valid = sorted_lattice(x)
    ts = np.take_along_axis(x["ts"], order, 1)
    de = np.take_along_axis(x["dists"], order, 1)
    t_max = np.where(valid, ts + de, 0.0).max(1, keepdims=True)
    ts = np.maximum.accumulate(np.where(valid, ts, t_max), axis=1)
    de = np.where(valid, de, 0.0)
    ends = np.concatenate([ts[:, 1:], ts[:, -1:] + de[:, -1:]], 1)
    rng = np.random.default_rng(seed)
    if kind == "random":
        w = rng.random((N_RAYS, S)) ** 4
    elif kind == "zero":
        w = np.zeros((N_RAYS, S))
    else:
        w = np.zeros((N_RAYS, S))
        w[np.arange(N_RAYS), rng.integers(0, S, N_RAYS)] = 1.0
    return (ts.astype(np.float32), ends.astype(np.float32),
            w.astype(np.float32))


@pytest.mark.parametrize("weights", ["random", "zero", "one-hot"])
@pytest.mark.parametrize("jitter_seed", [None, 11])
def test_pdf_sample_matches_jax(weights, jitter_seed):
    """The resampled bins with the eval midpoints (no draws) and with
    injected uniform draws; each bin edge in the same CDF bin."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.ray_samplers import pdf_sample as jpdf
    from gfnerf_tpu_torch.model_components.ray_samplers import pdf_sample

    starts, ends, w = histogram(weights)
    key, jitter = jax_jitter(jitter_seed)
    want = jax.jit(jpdf, static_argnums=(4,))(
        key, jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(w), K)
    w_t = torch.as_tensor(w).requires_grad_(True)
    got = pdf_sample(torch.as_tensor(starts), torch.as_tensor(ends), w_t, K,
                     None if jitter is None else torch.as_tensor(jitter))
    edges = [np.concatenate([np.asarray(a), np.asarray(b)[:, -1:]], 1)
             for a, b in (want, got)]
    scale = float(np.abs(ends).max())
    for g, wt in zip(got, want):
        assert not g.requires_grad and g.shape == (N_RAYS, K)
        np.testing.assert_allclose(to_np(g), np.asarray(wt), rtol=0,
                                   atol=BINS_ATOL_REL * scale)
    assert (np.diff(edges[1], axis=1) >= 0).all()
    # the marched bin each new edge falls in
    bins = np.concatenate([starts[:, :1], ends], 1)
    for e in edges:
        assert ((e >= bins[:, :1]) & (e <= bins[:, -1:])).all()
    jb = [np.array([np.searchsorted(b, v, side="right") for v in row])
          for row, b in zip(edges[0], bins)]
    pb = [np.array([np.searchsorted(b, v, side="right") for v in row])
          for row, b in zip(edges[1], bins)]
    flips = sum(int((a != b).sum()) for a, b in zip(jb, pb))
    assert flips == 0, f"{flips} bin edges in another marched bin"


def test_losses_match_jax():
    """interlevel_loss and distortion_loss: values, and their gradients
    (the probe's weights for the interlevel loss; the fine weights for the
    distortion loss)."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.losses import (
        distortion_loss as jdist, interlevel_loss as jinter)
    from gfnerf_tpu_torch.model_components.losses import (distortion_loss,
                                                          interlevel_loss)
    from gfnerf_tpu_torch.model_components.ray_samplers import pdf_sample

    cs, ce, wc = histogram("random", seed=1)
    wc = wc / wc.sum(1, keepdims=True) * 0.9
    fs, fe = (to_np(t) for t in pdf_sample(
        torch.as_tensor(cs), torch.as_tensor(ce), torch.as_tensor(wc), K))
    rng = np.random.default_rng(2)
    wf = (rng.random((N_RAYS, K)) / K).astype(np.float32)

    jv, jg = jax.value_and_grad(lambda w: jinter(
        jnp.asarray(wf), jnp.asarray(fs), jnp.asarray(fe), w,
        jnp.asarray(cs), jnp.asarray(ce)))(jnp.asarray(wc))
    wc_t = torch.as_tensor(wc).requires_grad_(True)
    wf_t = torch.as_tensor(wf).requires_grad_(True)
    v = interlevel_loss(wf_t, torch.as_tensor(fs), torch.as_tensor(fe), wc_t,
                        torch.as_tensor(cs), torch.as_tensor(ce))
    v.backward()
    assert wf_t.grad is None   # the fine weights are constants
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(to_np(wc_t.grad), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())

    jv, jg = jax.value_and_grad(lambda w: jdist(
        w, jnp.asarray(fs), jnp.asarray(fe)))(jnp.asarray(wf))
    wf_t = torch.as_tensor(wf).requires_grad_(True)
    v = distortion_loss(wf_t, torch.as_tensor(fs), torch.as_tensor(fe))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(to_np(wf_t.grad), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


# ---- the proposal branch of model_forward ----


def forward_pair(stage, jitter_seed, jax_bins=False, warp_mode="pers"):
    """(JAX outputs, port outputs) of the proposal branch on the fixture's
    marched samples at ``stage`` (block 1 at the block stage); with
    ``jax_bins`` the port's resampler hands back JAX's bins."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JaxModelConfig
    from gfnerf_tpu.models.gfnerf import model_forward as jax_forward
    from gfnerf_tpu_torch.models import gfnerf as model
    from gfnerf_tpu_torch.models.gfnerf import GFNeRFModelConfig

    joct, toct, _, _, o, d = scene12()
    jcfg, params, statics, field = field12(warp_mode=warp_mode)
    x = marched12()
    mkw = dict(n_blocks=2, scale_factor=1.0, num_proposal_resamples=K,
               samples_budget_per_ray=S)
    key, jitter = jax_jitter(jitter_seed)
    rel = np.arange(N_RAYS) % 12
    jout = jax.jit(lambda p, smp, key: jax_forward(
        p, statics, jcfg, JaxModelConfig(**mkw), smp, jnp.asarray(d),
        jnp.asarray(rel, jnp.int32), stage, 1, oct_dev=joct,
        warp_deferred=True, rays_o=jnp.asarray(o), rng=key))(
            params, tp.jax_samples(x), key)
    pdf = model.pdf_sample
    if jax_bins:
        bins = tuple(torch.as_tensor(np.array(t))
                     for t in jout["fine_spacing"])
        model.pdf_sample = lambda *a, **kw: bins
    try:
        tout = model.model_forward(
            field, GFNeRFModelConfig(**mkw), tp.port_samples(x),
            torch.as_tensor(d), torch.as_tensor(rel), stage, toct, 1,
            rays_o=torch.as_tensor(o),
            prop_u=None if jitter is None else torch.as_tensor(jitter))
    finally:
        model.pdf_sample = pdf
    return jout, tout


def close_but_one_ray(got, want, atol, what):
    """Every ray within ``atol`` but at most one (a fine sample across a
    hash cell's edge, see the module docstring)."""
    err = np.abs(got - want).reshape(got.shape[0], -1).max(1)
    assert (err > atol).sum() <= 1, (what, err.max(), (err > atol).sum())


@pytest.mark.parametrize("jitter_seed", [None, 11])
@pytest.mark.parametrize("stage", [0, 1])
def test_proposal_forward_matches_jax(stage, jitter_seed):
    """rgb, weights, the probe's weights, both spacings, the march weights
    and the fine anchors; then the same with JAX's bins handed to the
    port, to f32 rounding."""
    jout, tout = forward_pair(stage, jitter_seed)
    x = marched12()
    assert tout["weights"].shape == (N_RAYS, K)
    assert tout["march_weights"].shape == (N_RAYS, S)
    np.testing.assert_array_equal(to_np(tout["fine_anchors"]),
                                  jax_fine_anchors(x, jout))
    for key in ("prop_spacing", "fine_spacing"):
        for g, w in zip(tout[key], jout[key]):
            np.testing.assert_allclose(
                to_np(g), np.asarray(w), rtol=0,
                atol=BINS_ATOL_REL * float(np.abs(np.asarray(w)).max()))
    for key in ("prop_weights", "march_weights", "march_alphas"):
        np.testing.assert_allclose(to_np(tout[key]), np.asarray(jout[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    assert float(to_np(tout["weights"]).max()) > 0.05
    for key, atol in (("rgb", 1e-5), ("accumulation", 5e-5),
                      ("weights", 5e-5), ("depth", 5e-5)):
        want = np.asarray(jout[key])
        close_but_one_ray(to_np(tout[key]), want,
                          atol * max(1.0, float(np.abs(want).max())), key)

    jout, tout = forward_pair(stage, jitter_seed, jax_bins=True)
    for key in ("rgb", "accumulation", "weights", "depth"):
        np.testing.assert_allclose(to_np(tout[key]), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_identity_warp_matches_jax():
    """The identity-warp ablation (world / 6 clipped to [-1.5, 1.5]) on the
    dense branch and on the proposal branch, with JAX's bins."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JaxModelConfig
    from gfnerf_tpu.models.gfnerf import model_forward as jax_forward
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                model_forward)

    joct, toct, _, _, _, d = scene12()
    jcfg, params, statics, field = field12(warp_mode="identity")
    x = marched12()
    mkw = dict(n_blocks=2, scale_factor=1.0, samples_budget_per_ray=S)
    jout = jax.jit(lambda p, smp: jax_forward(
        p, statics, jcfg, JaxModelConfig(**mkw), smp, jnp.asarray(d),
        jnp.zeros((N_RAYS,), jnp.int32), 0, 0, oct_dev=joct,
        warp_deferred=True))(params, tp.jax_samples(x))
    tout = model_forward(field, GFNeRFModelConfig(**mkw), tp.port_samples(x),
                         torch.as_tensor(d), torch.zeros(N_RAYS).long(), 0,
                         toct)
    for key in ("rgb", "weights", "depth"):
        np.testing.assert_allclose(to_np(tout[key]), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    jout, tout = forward_pair(0, None, jax_bins=True, warp_mode="identity")
    np.testing.assert_array_equal(to_np(tout["fine_anchors"]),
                                  jax_fine_anchors(x, jout))
    for key in ("rgb", "weights", "prop_weights"):
        np.testing.assert_allclose(to_np(tout[key]), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("stage_is_block", [False, True])
def test_render_fn_matches_jax(stage_is_block):
    """make_render_fn on the proposal branch (eval draws: the bin
    midpoints) against the JAX package's, one block for the chunk at the
    block stage; a block per ray is refused."""
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JaxModelConfig
    from gfnerf_tpu.models.gfnerf import make_render_fn as jax_render_fn
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JaxSampler
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct, _, _, o, d = scene12()
    jcfg, params, statics, field = field12()
    mkw = dict(n_blocks=2, scale_factor=1.0, num_proposal_resamples=K,
               samples_budget_per_ray=S)
    skw = dict(max_samples=S, sample_l=1.0 / 64)
    want = jax_render_fn(jcfg, JaxModelConfig(**mkw), JaxSampler(**skw))(
        params, statics, joct, jnp.asarray(o), jnp.asarray(d), 3, 1,
        stage_is_block)
    render = make_render_fn(GFNeRFModelConfig(**mkw), SamplerConfig(**skw))
    got = render(field, toct, torch.as_tensor(o), torch.as_tensor(d), 3, 1,
                 stage_is_block)
    assert sorted(got) == sorted(want)
    for key in ("rgb", "accumulation", "depth"):
        w = np.asarray(want[key])
        close_but_one_ray(to_np(got[key]), w,
                          5e-5 * max(1.0, float(np.abs(w).max())), key)
    np.testing.assert_allclose(to_np(got["oct_depth"]),
                               np.asarray(want["oct_depth"]), rtol=1e-6)
    if stage_is_block:
        with pytest.raises(ValueError, match="block per ray"):
            render(field, toct, torch.as_tensor(o), torch.as_tensor(d), 3,
                   torch.zeros(N_RAYS, dtype=torch.long), True)


# ---- train steps ----

STEP_MKW = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S,
                num_proposal_resamples=K)


def _jax_grads(opt_state):
    """The JAX step's gradients by group, from Adam's first moment (mu =
    (1 - b1) g after one update)."""
    inner = opt_state.inner_state.inner_states
    return {name: [np.asarray(m) / 0.1 for m in
                   tp.jax_groups(inner[name].inner_state[0].mu[0])[name]]
            for name in ("fields", "base_encoding_init")}


def test_proposal_train_steps_match_jax():
    """An init-stage step against the JAX step with its draws injected
    (march noise, S3IM permutations, the resampling's uniforms): losses,
    the gradients of the probe's table and MLP and of the global table,
    the occupancy statistics (fed the probe's weights).  Then a focal
    step on block 0: the probe gets no gradient and stays bit for bit."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    jcfg, params, statics, field = field_pair(**PROBE)
    joct, toct = octree_pair()
    batch = tp.train_batch(seed=4)
    (jstate, jo, jm, jerr), noise, perms = tp.jax_train_step(
        jcfg, params, statics, joct, batch, STEP_MKW, key_seed=6)
    prop_u = tp.jax_prop_u(6, K)
    state, to, tm, terr = tp.port_train_step(field, toct, batch, STEP_MKW,
                                             noise, perms, prop_u=prop_u)
    assert float(tm["interlevel_loss"]) > 0
    for key in ("loss", "rgb_loss", "s3im_loss", "interlevel_loss", "psnr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    groups = field_param_groups(field)
    jg = _jax_grads(jstate.opt_state)
    n_probe = 1 + 2 * len(field.prop_net.w)
    assert len(groups["fields"]) == len(jg["fields"])
    for name, tol in (("fields", 1e-3), ("base_encoding_init", TABLE_TOL)):
        scale = max(float(np.abs(g).max()) for g in jg[name])
        for i, (p, want) in enumerate(zip(groups[name], jg[name])):
            is_table = name == "base_encoding_init" or (
                i == len(groups[name]) - n_probe)
            atol = (TABLE_TOL * float(np.abs(want).max()) if is_table
                    else tol * scale)
            assert p.grad is not None, (name, i)
            np.testing.assert_allclose(to_np(p.grad), want, rtol=0,
                                       atol=atol, err_msg=f"{name}[{i}]")
    assert float(field.prop_feat.grad.abs().max()) > 0
    for key in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(to_np(getattr(to, key)),
                                      np.asarray(getattr(jo, key)),
                                      err_msg=key)
    assert not np.array_equal(to_np(to.visit_cnt), to_np(toct.visit_cnt))

    # the focal stage: the probe is frozen and stays out of the backward
    probe = [to_np(p).copy() for p in groups["fields"][-n_probe:]]
    stack = to_np(field.block_feats).copy()
    state, _, fm, _ = tp.port_train_step(field, to, batch, STEP_MKW, noise,
                                         perms, stage=1, active_block=0,
                                         prop_u=prop_u)
    assert np.isfinite(float(fm["interlevel_loss"]))
    for p, before in zip(field_param_groups(field)["fields"][-n_probe:],
                         probe):
        assert p.grad is None
        np.testing.assert_array_equal(to_np(p), before)
    assert not np.array_equal(to_np(field.block_feats)[0], stack[0])
    np.testing.assert_array_equal(to_np(field.block_feats)[1], stack[1])


# ---- configs and the pipeline ----


def test_prop_method_config_through_config_io():
    """get_method("gf-nerf-prop") field for field against the JAX
    package's, after a JSON round trip; its proposal fields set."""
    from gfnerf_tpu.configs.method_configs import method_configs
    from gfnerf_tpu_torch.configs.config_io import (config_from_json,
                                                    config_to_json)
    from gfnerf_tpu_torch.configs.method_configs import get_method

    cfg = get_method("gf-nerf-prop")
    back = config_from_json(config_to_json(cfg))
    assert back == cfg
    want = method_configs["gf-nerf-prop"]()
    p, wp = back.pipeline, want.pipeline
    for name in ("field_use_proposal", "field_proposal_levels",
                 "field_proposal_rows_log2", "field_warp_mode",
                 "field_hash_layout", "field_mlp_dtype", "steps_per_dispatch"):
        assert getattr(p, name) == getattr(wp, name), name
    for name in ("num_proposal_resamples", "proposal_interlevel_mult",
                 "distortion_loss_mult", "samples_budget_per_ray"):
        assert getattr(p.model, name) == getattr(wp.model, name), name
    assert p.sampler.max_samples == wp.sampler.max_samples == 256
    assert p.field_use_proposal and p.model.num_proposal_resamples == 64


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("prop_scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


PIPE_STEPS = 12     # 10 init steps, the transition, 2 focal steps
PIPE_RAYS = 128
PIPE_PATCH_H = 8


def prop_tiny_config(scene, out_dir):
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config

    cfg = gf_nerf_tiny_config()
    cfg.max_num_iterations = PIPE_STEPS
    cfg.output_dir = out_dir
    cfg.data = scene
    cfg.device = "cpu"
    cfg.pipeline.datamanager.train_num_rays_per_batch = PIPE_RAYS
    cfg.pipeline.model.s3im_patch_height = PIPE_PATCH_H
    for key, value in PROP_OVERRIDES["prop"].items():
        apply_override(cfg.pipeline, key, str(value))
    return cfg


def test_pipeline_matches_jax_with_proposal(scene_dir, tmp_path):
    """gf-nerf-tiny with the probe through the port's pipeline and the JAX
    package's (tests/torch_pipeline_ref.py, layout "prop") for 12 steps
    across the transition, the JAX run's draws injected: batches, splits
    and losses (interlevel included) per step, the eval batches (not
    routed: a stream per block); the early-termination renderer refused.

    Tolerances: the JAX run skips its first four updates (see below); up
    to the probe's first update (step 4) every loss agrees to 4e-6
    relative (measured 2.6e-6).  From then on the interlevel loss, whose
    (inner - w)^2 / (w + 1e-7) divides by probe weights near 1e-7, turns
    the resampler's ulp differences (see the module docstring) into
    relative differences of up to 4.8e-3 (measured), and the probe's
    updates carry them on: the interlevel loss and the total to 1e-2, the
    rgb and S3IM losses to 5e-4 (measured 2.6e-4, the focal step), the
    eval PSNR to 1e-4 (measured 1.8e-5); batches equal through the
    transition, and at the focal step, whose error-guided rays read maps
    rendered by a drifted probe, at most 2% of the rays (measured 1 of
    128)."""
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer

    ref_dir = tmp_path / "jax_ref"
    ref_dir.mkdir()
    script = Path(__file__).with_name("torch_pipeline_ref.py")
    proc = subprocess.run(
        [sys.executable, str(script), str(scene_dir), str(ref_dir),
         str(PIPE_STEPS), str(PIPE_RAYS), str(PIPE_PATCH_H), "prop"],
        capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stdout.decode()[-4000:] + \
        proc.stderr.decode()[-4000:]
    ref = dict(np.load(ref_dir / "ref.npz"))

    cfg = prop_tiny_config(scene_dir, tmp_path / "out")
    p = cfg.pipeline.build(
        MinimalDataParser(MinimalDataParserConfig(data=scene_dir)),
        tmp_path / "out", device="cpu",
        draws=lambda step, r, s: (ref["noise"][step], ref["perms"][step],
                                  ref["prop_u"][step]))
    assert p.field.prop_feat is not None
    batches, losses, splits, blocks_seen = [], [], [], []
    next_train = p.datamanager.next_train

    def recording_next_train(step):
        batch = next_train(step)
        batches.append(batch["indices"].copy())
        return batch

    def recording(render_chunk):
        def render(*args):
            blocks_seen.append(args[5])
            return render_chunk(*args)
        return render

    p.datamanager.next_train = recording_next_train
    # where a ray marches no valid sample, the JAX step places its masked
    # fine samples at the ray's origin, whose warp is NaN, and its table
    # gradient is NaN: apply_if_finite drops the whole update.  The port
    # places them where the march puts masked slots, and updates.  The
    # port's run skips the updates the JAX run skipped, so that the two
    # stay comparable after them.
    jax_skipped = {int(i) for i in np.nonzero(~ref["applied"])[0]}
    assert jax_skipped == {0, 1, 2, 3}
    update, current = p.tx.update, {}

    def update_as_jax(grads, state, params):
        if current["step"] in jax_skipped:
            assert all(torch.isfinite(g).all() for gs in grads.values()
                       for g in gs if g is not None)
            return ({name: [None] * len(gs) for name, gs in grads.items()},
                    dataclasses.replace(
                        state, total_notfinite=state.total_notfinite + 1,
                        last_finite=False))
        return update(grads, state, params)

    p.tx.update = update_as_jax
    keys = LOSS_KEYS + ("interlevel_loss",)
    evals = {}
    for step in range(PIPE_STEPS):
        current["step"] = step
        m = p.get_train_loss_dict(step)
        losses.append([m[k] for k in keys])
        p.after_train_iteration(step)
        splits.append(p.datamanager.split_idx)
        if (step + 1) % cfg.steps_per_eval_batch == 0 \
                or step == PIPE_STEPS - 1:
            blocks_seen.clear()
            render_chunk, p._render_chunk = (p._render_chunk,
                                             recording(p._render_chunk))
            evals[step] = p.get_eval_loss_dict(step)["eval_psnr"]
            p._render_chunk = render_chunk
            # one block a stream, never a block per ray
            assert blocks_seen and all(isinstance(b, (int, np.integer))
                                       for b in blocks_seen)
    # every batch through the transition; the focal split's batch samples
    # 20% of its rays by the error maps, which the probe's drift moves
    got_idx = np.stack(batches)
    assert int(ref["transition"]) == 10
    np.testing.assert_array_equal(got_idx[:11], ref["indices"][:11])
    assert (got_idx[11:] != ref["indices"][11:]).any(-1).mean() <= 0.02
    np.testing.assert_array_equal(splits, ref["splits"])
    got, want = np.asarray(losses), ref["losses"]
    # before the probe's first update (step 4) every loss to 4e-6
    np.testing.assert_allclose(got[:5], want[:5], rtol=4e-6, atol=1e-9)
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=5e-4)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    for step, psnr in evals.items():
        np.testing.assert_allclose(psnr, ref[f"eval_psnr{step}"], rtol=1e-4)
    # the probe's table after its six updates: Adam's sign flips on
    # near-zero gradients (tests/test_torch_pipeline.py), here on a loss
    # that drifts as above: at most 10% of the entries off by more than
    # 1e-4, none by more than three steps of the learning rate (measured
    # 5.5%, 0.0233)
    diff = np.abs(to_np(p.field.prop_feat) - ref["prop_feat"])
    assert (diff > 1e-4).mean() <= 0.1 and diff.max() <= 3e-2, diff.max()

    with pytest.raises(ValueError, match="proposal"):
        p.enable_early_term()
    with pytest.raises(ValueError, match="proposal"):
        EarlyTermRenderer(p.config.model, p.sampler.sampler_config)
    p.config.eval_early_term = True
    p._build_early_renderer()
    assert p._early_renderer is None


def test_render_entry_point_refuses_early_term_on_proposal(scene_dir,
                                                          tmp_path):
    """python -m gfnerf_tpu_torch.render --early-term on a proposal run's
    checkpoint fails with a clear error; without it the frames render."""
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.train import main as train_main

    args = ["gf-nerf-tiny", "--data", str(scene_dir), "--device", "cpu",
            "--max-num-iterations", "3", "--output-dir", str(tmp_path),
            "--experiment-name", "run",
            "pipeline.datamanager.train_num_rays_per_batch=64",
            "pipeline.model.s3im_patch_height=4"]
    args += [f"pipeline.{k}={v}" for k, v in PROP_OVERRIDES["prop"].items()]
    assert train_main(args) == 0
    config = next(tmp_path.glob("run/gf-nerf-tiny/*/config.json"))
    render = ["--load-config", str(config), "--traj", "spiral",
              "--spiral-steps", "1", "--output-path", str(tmp_path / "f")]
    with pytest.raises(ValueError, match="proposal"):
        render_entry.main(render + ["--early-term"])
    render_entry.main(render)
    assert len(list((tmp_path / "f").glob("*.png"))) == 1
