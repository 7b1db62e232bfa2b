"""One init-stage train step of the port (gfnerf_tpu_torch.models.gfnerf.
make_train_step) against the JAX package's jitted ``make_train_step`` on the
tiny scene, from identical parameters, octree, batch, march noise and S3IM
permutations (drawn on the JAX side from the step's own key split and
handed to the port).

Tolerances:
- f32 MLPs: loss and its parts to 1e-5 relative; the per-ray error to
  1e-5; the MLP and appearance gradients to rtol 1e-3 with an atol of 1e-3
  of the group's largest gradient (sums over the R * S samples, which
  cancel, taken in other orders; measured 8e-5); the table gradient at
  the JAX packed-hash tests' own tolerance, rtol 2e-2 and atol 2e-2 of its
  largest entry (the JAX backward rounds its payload to bf16, the port
  sums in f32).  The updated OctreeDevice is equal.
- bf16 MLPs: a hidden activation can round to a neighbouring bf16 value in
  one package and not the other (tests/test_torch_field.py), so the loss
  to 1e-3 relative, the gradients to 5e-2 of the group's largest, and at
  most 1% of the occupancy statistics may differ.
- Adam moves a parameter by about lr * sign(g) on its first step, so a
  near-zero gradient whose sign differs flips the update: the updated
  parameters are compared, to 1e-5, only where |g_jax| exceeds twice the
  gradient tolerance.
"""

import numpy as np
import pytest
import torch

from torch_parity import IMG_WH, field_pair, octree_pair, to_np
from torch_parity import TRAIN_R as R
from torch_parity import TRAIN_S as S
from torch_parity import TRAIN_SAMPLE_L as SAMPLE_L
from torch_parity import jax_groups as _jax_groups
from torch_parity import jax_train_step as _jax_step
from torch_parity import port_train_step as _port_step
from torch_parity import train_batch as _batch
from torch_parity import train_cameras_np as _cameras_np

TABLE_TOL = 2e-2


def _jax_grads(opt_state):
    """The step's gradients, read back from Adam's first moment: after one
    update mu = (1 - b1) g."""
    inner = opt_state.inner_state.inner_states
    grads = {}
    for name in ("fields", "base_encoding_init"):
        mu = inner[name].inner_state[0].mu[0]
        grads[name] = [np.asarray(m) / 0.1
                       for m in _jax_groups(mu)[name]]
    return grads


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(mlp_dtype):
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    f32 = mlp_dtype == "float32"
    jcfg, params, statics, field = field_pair(mlp_dtype=mlp_dtype)
    joct, toct = octree_pair()
    batch = _batch()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=S)
    (jstate, jo, jm, jerr), noise, perms = _jax_step(
        jcfg, params, statics, joct, batch, mkw, key_seed=5)
    before = {k: [to_np(p).copy() for p in ps]
              for k, ps in field_param_groups(field).items()}
    state, to, tm, terr = _port_step(field, toct, batch, mkw, noise, perms)

    # losses and metrics
    assert float(jm["num_samples_per_ray"]) > 20
    loss_rtol = 1e-5 if f32 else 1e-3
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr",
              "num_samples_per_ray", "frac_truncated_rays"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=loss_rtol, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                               rtol=loss_rtol, atol=1e-5 if f32 else 2e-3)

    # gradients, per group
    groups = field_param_groups(field)
    jg = _jax_grads(jstate.opt_state)
    assert float(np.abs(to_np(field.global_feat.grad)).max()) > 0
    for name, (rtol, atol_rel) in {
            "fields": (1e-3, 1e-3) if f32 else (5e-2, 5e-2),
            "base_encoding_init": (TABLE_TOL, TABLE_TOL)}.items():
        scale = max(float(np.abs(g).max()) for g in jg[name])
        for i, (p, want) in enumerate(zip(groups[name], jg[name])):
            np.testing.assert_allclose(to_np(p.grad), want, rtol=rtol,
                                       atol=atol_rel * scale,
                                       err_msg=f"{name}[{i}] grad")
    assert field.block_feats.grad is None   # not in the init-stage graph
    assert state.opt_state.count == 1
    assert state.opt_state.mu["block"] == [None]   # zero moments
    assert state.step == 1

    # updated parameters where the gradient is well above its tolerance
    jp = _jax_groups(jstate.params)
    for name in ("fields", "base_encoding_init"):
        tol = (TABLE_TOL if name == "base_encoding_init" else
               1e-3 if f32 else 5e-2)
        scale = max(float(np.abs(g).max()) for g in jg[name])
        for i, (p, want, g) in enumerate(zip(groups[name], jp[name],
                                             jg[name])):
            sure = np.abs(g) > 2 * tol * scale
            got = to_np(p)
            np.testing.assert_allclose(got[sure], np.asarray(want)[sure],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}[{i}] param")
            assert not np.array_equal(got, before[name][i]), (name, i)
    np.testing.assert_array_equal(to_np(field.block_feats),
                                  np.asarray(jstate.params.block_feats))

    # the occupancy statistics
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        got, want = to_np(getattr(to, k)), np.asarray(getattr(jo, k))
        if f32:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert (got != want).mean() <= 0.01, k
    assert not np.array_equal(to_np(to.visit_cnt), to_np(toct.visit_cnt))


def test_non_finite_step_is_skipped():
    """A NaN in the loss skips the update: parameters, moments and counts
    stay where they were, and the skip is counted."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    _, _, _, field = field_pair(mlp_dtype="float32")
    _, toct = octree_pair()
    batch = _batch(seed=1)
    batch["image"][3, 1] = np.nan
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=S)
    rng = np.random.default_rng(2)
    noise = rng.uniform(0.5, 1.5, (R, S)).astype(np.float32)
    perms = np.stack([rng.permutation(R) for _ in range(9)])
    before = [to_np(p).copy() for ps in field_param_groups(field).values()
              for p in ps]
    state, _, metrics, _ = _port_step(field, toct, batch, mkw, noise, perms)
    assert not np.isfinite(float(metrics["loss"]))
    after = [to_np(p) for ps in field_param_groups(field).values()
             for p in ps]
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)
    opt = state.opt_state
    assert not opt.last_finite and opt.total_notfinite == 1
    assert opt.count == 0
    assert all(m is None for ms in opt.mu.values() for m in ms)


def test_train_step_rejects_focal_stage():
    """Where the focal step cannot run it is refused: a stage that does not
    exist, and a field without block tables."""
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    with pytest.raises(ValueError):
        make_train_step(GFNeRFModelConfig(), SamplerConfig(),
                        build_optimizer(OptimizersConfig()), STAGE_BLOCK + 1)
    _, _, _, field = field_pair(mlp_dtype="float32", n_blocks=0)
    _, toct = octree_pair()
    rng = np.random.default_rng(2)
    noise = rng.uniform(0.5, 1.5, (R, S)).astype(np.float32)
    perms = np.stack([rng.permutation(R) for _ in range(9)])
    with pytest.raises(ValueError):
        _port_step(field, toct, _batch(), dict(
            scale_factor=1.0, samples_budget_per_ray=S), noise, perms,
            stage=STAGE_BLOCK)


def test_train_steps_lower_the_loss():
    """A plain loop of port steps on the tiny scene, batches drawn by
    train_bench.make_batch from the sphere renders, noise and permutations
    from the step's generator: the loss falls, the global table gets a
    gradient, the block tables stay, the occupancy statistics move."""
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                init_train_state,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from gfnerf_tpu_torch.train_bench import make_batch
    from gfnerf_tpu_torch.utils.synthetic import render_spheres

    _, _, _, field = field_pair(mlp_dtype="bfloat16")
    _, toct = octree_pair()
    c2w, fx, fy, cx, cy = _cameras_np()
    w, h = IMG_WH
    images = render_spheres(c2w, fx, fy, cx, cy, w, h)
    cams = Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device="cpu")
    tx = build_optimizer(OptimizersConfig())
    state = init_train_state(field, tx)
    step = make_train_step(
        GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=S),
        SamplerConfig(max_samples=S, sample_l=SAMPLE_L), tx)
    batch = make_batch(images, R, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    block0 = field.block_feats.detach().clone()
    oct_dev, losses = toct, []
    for _ in range(6):
        state, oct_dev, metrics, err = step(state, oct_dev, cams, batch, 1.0,
                                            generator=gen)
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert err.shape == (R,)
    assert float(field.global_feat.grad.abs().max()) > 0
    # f32 gradients for every parameter through the bf16 MLPs
    assert all(p.grad.dtype == torch.float32 for p in field.parameters()
               if p.grad is not None)
    assert torch.equal(field.block_feats, block0)
    assert state.step == 6 and state.opt_state.count == 6
    assert not torch.equal(oct_dev.visit_cnt, toct.visit_cnt)
