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

from torch_parity import N_CAMS, IMG_WH, field_pair, octree_pair, to_np

R = 128
S = 64
SAMPLE_L = 1.0 / 32
TABLE_TOL = 2e-2


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    w, h = IMG_WH
    ki = rng.integers(0, N_CAMS, R).astype(np.int32)
    coords = np.stack([rng.integers(0, h, R) + 0.5,
                       rng.integers(0, w, R) + 0.5], -1).astype(np.float32)
    image = rng.uniform(0.2, 0.9, (R, 3)).astype(np.float32)
    return {"camera_indices": ki, "rel_camera_indices": ki,
            "coords": coords, "image": image}


def _cameras_np():
    from tests.conftest import make_ring_cameras

    c2w, intri = make_ring_cameras(N_CAMS, img_wh=IMG_WH)
    return (c2w, intri[:, 0, 0], intri[:, 1, 1], intri[:, 0, 2],
            intri[:, 1, 2])


def _jax_step(jcfg, params, statics, joct, batch, mkw, key_seed):
    """The JAX step, its outputs, and the noise and permutations it drew."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.data.dataparsers.base import CamerasHost
    from gfnerf_tpu.engine.optimizers import (OptimizersConfig,
                                              build_optimizer, optimizer_arg)
    from gfnerf_tpu.fields.field import STAGE_INIT
    from gfnerf_tpu.models.gfnerf import (GFNeRFModelConfig, TrainState,
                                          make_train_step)
    from gfnerf_tpu.sampler.perssampler import SamplerConfig

    c2w, fx, fy, cx, cy = _cameras_np()
    w, h = IMG_WH
    cams = CamerasHost(camera_to_worlds=c2w, fx=fx, fy=fy, cx=cx, cy=cy,
                       width=np.full(N_CAMS, w, np.int32),
                       height=np.full(N_CAMS, h, np.int32)).to_device()
    tx = build_optimizer(OptimizersConfig(), params)
    state = TrainState(params=params, opt_state=tx.init(optimizer_arg(params)),
                       step=jnp.asarray(0, jnp.int32))
    mcfg = GFNeRFModelConfig(n_blocks=2, **mkw)
    step = make_train_step(jcfg, mcfg, SamplerConfig(max_samples=S,
                                                     sample_l=SAMPLE_L),
                           tx, STAGE_INIT)
    key = jax.random.PRNGKey(key_seed)
    out = step(state, statics, joct, cams,
               {k: jnp.asarray(v) for k, v in batch.items()},
               jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32), key)
    # the step's own draws (gfnerf.py:512-514, losses.py:70-73)
    k_noise, k_s3im, _ = jax.random.split(key, 3)
    noise = (jax.random.uniform(k_noise, (R, S)) - 0.5) + 1.0
    perms = [jax.random.permutation(k, R) for k in
             jax.random.split(k_s3im, mcfg.s3im_repeat_time - 1)]
    return out, np.array(noise), np.stack([np.asarray(p) for p in perms])


def _port_step(field, toct, batch, mkw, noise, perms):
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                init_train_state,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    w, h = IMG_WH
    cams = Cameras.from_numpy(*_cameras_np(), w, h, device="cpu")
    tx = build_optimizer(OptimizersConfig())
    state = init_train_state(field, tx)
    step = make_train_step(GFNeRFModelConfig(**mkw),
                           SamplerConfig(max_samples=S, sample_l=SAMPLE_L),
                           tx)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ("camera_indices", "rel_camera_indices"):
        tb[k] = tb[k].long()
    return step(state, toct, cams, tb, 1.0, noise=torch.as_tensor(noise),
                s3im_perms=torch.as_tensor(perms).long())


def _jax_groups(tree):
    """A JAX FieldParams-shaped tree as the port's group lists."""
    return {
        "fields": [*tree.base_net["w"], *tree.base_net["b"],
                   *tree.mlp_head["w"], *tree.mlp_head["b"],
                   tree.appearance_embedding],
        "base_encoding_init": [tree.global_feat],
    }


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
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    with pytest.raises(NotImplementedError):
        make_train_step(GFNeRFModelConfig(), SamplerConfig(),
                        build_optimizer(OptimizersConfig()), STAGE_BLOCK)


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
