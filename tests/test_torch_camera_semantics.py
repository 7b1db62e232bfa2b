"""The port's camera optimizer and semantics on the GF-NeRF path against
the JAX package's on the CPU: ``exp_map_so3``, ``exp_map_se3``,
``apply_to_rays`` and ``pose_regularization`` (values and gradients, at
zero tangents, where every run starts, and at nonzero ones); the field's
parameters with the semantics heads and the camera tangents (the numpy
draws in the JAX order, with the proposal probe after them);
``model_forward``'s rendered semantic logits on the dense, compacted and
proposal branches; one init-stage train step with semantics and SO3xR3
(the loss terms and the gradients of the semantics MLPs, the camera
tangents and the rest); the road masks as the batches' labels; and
tests/test_train_smoke.py's semantic and camera-optimizer runs through
the port's Trainer.

Tolerances (1e-5 relative unless said):
- the Lie maps: values to 1e-6 absolute (entries of order 1), gradients
  to 1e-5 of their largest.  Both finite at exactly zero tangents.
- the forward: the semantic logits as the colour (1e-4 relative, 1e-5
  absolute: test_torch_compaction's), with JAX's bins handed over on the
  proposal branch.
- the train step: test_torch_train's (the losses to 1e-5 relative; the
  MLP gradients, the semantics heads' included, to 1e-3 of the group's
  largest, measured 8e-5 there); the camera tangents' gradient to 1e-3 of
  its largest (a sum over the rays' colour-head gradients, taken in
  another order: measured below 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import to_np

MODES = ["SO3xR3", "SE3"]


def tangents(kind, n=5, seed=0):
    if kind == "zero":
        return np.zeros((n, 6), np.float32)
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 0.3, (n, 6)).astype(np.float32)
    if kind == "tiny":   # below the small-angle switch, theta^2 < 1e-10
        t[:, 3:] *= 1e-6
    return t


@pytest.mark.parametrize("kind", ["zero", "tiny", "nonzero"])
def test_exp_maps_match_jax(kind):
    """exp_map_so3 and exp_map_se3: values, and the gradient of a random
    linear function of them, finite at zero."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.cameras import camera_optimizers as jco
    from gfnerf_tpu_torch.cameras import camera_optimizers as tco

    tang = tangents(kind)
    rng = np.random.default_rng(9)
    w_r = rng.normal(size=(5, 3, 3)).astype(np.float32)
    w_t = rng.normal(size=(5, 3)).astype(np.float32)

    def jf(t):
        rot = jco.exp_map_so3(t[:, 3:])
        r2, tr = jco.exp_map_se3(t)
        return (jnp.sum(rot * w_r) + jnp.sum(r2 * w_r * 0.5)
                + jnp.sum(tr * w_t)), (rot, r2, tr)

    (jv, jouts), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(tang))
    t = torch.as_tensor(tang).requires_grad_(True)
    rot = tco.exp_map_so3(t[:, 3:])
    r2, tr = tco.exp_map_se3(t)
    v = (torch.sum(rot * torch.as_tensor(w_r))
         + torch.sum(r2 * torch.as_tensor(w_r) * 0.5)
         + torch.sum(tr * torch.as_tensor(w_t)))
    v.backward()
    for got, want in zip((rot, r2, tr), jouts):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert torch.isfinite(t.grad).all()
    jg = np.asarray(jg)
    np.testing.assert_allclose(to_np(t.grad), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    if kind == "zero":
        np.testing.assert_array_equal(to_np(rot), np.broadcast_to(
            np.eye(3, dtype=np.float32), (5, 3, 3)))


@pytest.mark.parametrize("kind", ["zero", "nonzero"])
@pytest.mark.parametrize("mode", MODES + ["off"])
def test_apply_to_rays_matches_jax(mode, kind):
    """apply_to_rays (each ray moved by its camera's delta) and
    pose_regularization: values and the tangents' gradient."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.cameras import camera_optimizers as jco
    from gfnerf_tpu_torch.cameras import camera_optimizers as tco

    tang = tangents(kind)
    o, d = tp.tiny_rays(16)
    cams = (np.arange(16) % 5).astype(np.int32)
    rng = np.random.default_rng(2)
    w_o, w_d = (rng.normal(size=(16, 3)).astype(np.float32)
                for _ in range(2))
    jcfg, tcfg = jco.CameraOptimizerConfig(mode), tco.CameraOptimizerConfig(
        mode)

    def jf(t):
        no, nd = jco.apply_to_rays(jcfg, t, jnp.asarray(cams), jnp.asarray(o),
                                   jnp.asarray(d))
        reg = jco.pose_regularization(jcfg, t)
        return jnp.sum(no * w_o) + jnp.sum(nd * w_d) + 10.0 * reg, (no, nd,
                                                                     reg)

    (_, (jo, jd, jreg)), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(tang))
    t = torch.as_tensor(tang).requires_grad_(True)
    no, nd = tco.apply_to_rays(tcfg, t, torch.as_tensor(cams).long(),
                               torch.as_tensor(o), torch.as_tensor(d))
    reg = tco.pose_regularization(tcfg, t)
    total = (torch.sum(no * torch.as_tensor(w_o))
             + torch.sum(nd * torch.as_tensor(w_d)) + 10.0 * reg)
    np.testing.assert_allclose(to_np(no), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(nd), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(reg.detach()), float(jreg), rtol=1e-5,
                               atol=1e-12)
    if mode == "off":
        assert no is not None and not total.requires_grad
        return
    total.backward()
    jg = np.asarray(jg)
    np.testing.assert_allclose(to_np(t.grad), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    if kind == "zero":   # the identity: the rays as they were
        np.testing.assert_array_equal(to_np(no), o)
        np.testing.assert_array_equal(to_np(nd), d)
    with pytest.raises(ValueError):
        tco.apply_to_rays(tco.CameraOptimizerConfig("SO4"), t,
                          torch.as_tensor(cams).long(), torch.as_tensor(o),
                          torch.as_tensor(d))


def test_field_params_match_jax():
    """init_field_params with the semantics heads, the camera tangents and
    the proposal probe: every leaf bit for bit (the heads draw before the
    probe, the tangents draw nothing), and the round trip through
    params_from_jax / to_numpy."""
    import dataclasses

    from gfnerf_tpu.fields.field import FieldConfig as JaxFieldConfig
    from gfnerf_tpu.fields.field import init_field_params as jax_init
    from gfnerf_tpu_torch.fields.field import (FieldConfig, init_field_params,
                                               params_from_jax)

    kw = tp.field_kwargs(use_semantics=True, num_semantic_classes=3,
                         camera_opt_mode="SE3", use_proposal=True,
                         proposal_levels=3, proposal_rows_log2=9)
    jp, js = jax_init(JaxFieldConfig(**kw), seed=4)
    p, s = init_field_params(FieldConfig(**kw), seed=4)
    for j, t in ((jp, p), (js, s)):
        for f in dataclasses.fields(t):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if isinstance(b, dict):
                for part in ("w", "b"):
                    for x, y in zip(a[part], b[part]):
                        np.testing.assert_array_equal(np.asarray(x), y)
            elif b is not None:
                np.testing.assert_array_equal(np.asarray(a), b, f.name)
    assert p.camera_adjustment.shape == (tp.N_CAMS, 6)
    assert not p.camera_adjustment.any()
    assert p.semantics_head["w"][-1].shape == (64, 3)
    field = params_from_jax(jp, js, FieldConfig(**kw), device="cpu")
    back, _ = field.to_numpy()
    np.testing.assert_array_equal(back.mlp_semantics["w"][0],
                                  np.asarray(jp.mlp_semantics["w"][0]))
    np.testing.assert_array_equal(back.camera_adjustment,
                                  np.asarray(jp.camera_adjustment))
    with pytest.raises(ValueError, match="camera optimizer"):
        init_field_params(FieldConfig(**dict(kw, camera_opt_mode="SO4")))


@pytest.mark.parametrize("branch", ["dense", "compacted", "proposal"])
def test_rendered_semantics_match_jax(branch):
    """model_forward's "semantics" (the per-sample logits of the detached
    geometry features, summed by the weights) on each branch, beside its
    rgb; on the proposal branch with JAX's resampled bins handed over."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import model_forward as jax_forward
    from gfnerf_tpu_torch.models import gfnerf as model

    over = dict(use_semantics=True, num_semantic_classes=3)
    mkw = dict(scale_factor=1.0, use_semantics=True)
    if branch == "proposal":
        over.update(use_proposal=True, proposal_levels=3,
                    proposal_rows_log2=9)
        mkw.update(num_proposal_resamples=16)
    jcfg, params, statics, field = tp.field_pair(**over)
    joct, toct = tp.octree_pair()
    x, d = tp.marched_np(n_rays=32, s=64)
    o, _ = tp.tiny_rays(n_rays=32, seed=3)
    mkw["samples_budget_per_ray"] = 16 if branch == "compacted" else 64
    rel = np.arange(32) % tp.N_CAMS
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, smp, key: jax_forward(
        p, statics, jcfg, JModel(n_blocks=2, **mkw), smp, jnp.asarray(d),
        jnp.asarray(rel, jnp.int32), 0, 0, oct_dev=joct,
        warp_deferred=True, rays_o=jnp.asarray(o), rng=key))(
            params, tp.jax_samples(x), key)
    pdf = model.pdf_sample
    prop_u = None
    if branch == "proposal":
        bins = tuple(torch.as_tensor(np.array(t))
                     for t in want["fine_spacing"])
        model.pdf_sample = lambda *a, **kw: bins
        prop_u = torch.zeros((32, 17))
    try:
        with torch.no_grad():
            got = model.model_forward(
                field, model.GFNeRFModelConfig(**mkw), tp.port_samples(x),
                torch.as_tensor(d), torch.as_tensor(rel), 0, toct,
                rays_o=torch.as_tensor(o), prop_u=prop_u)
    finally:
        model.pdf_sample = pdf
    assert got["semantics"].shape == (32, 3)
    assert float(np.abs(np.asarray(want["semantics"])).max()) > 1e-3
    for k in ("rgb", "semantics"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _jax_grads(opt_state):
    """The step's gradients by group, read back from Adam's first moment
    (after one update mu = (1 - b1) g)."""
    inner = opt_state.inner_state.inner_states
    return {name: [np.asarray(m) / 0.1 for m in tp.jax_groups(
        inner[name].inner_state[0].mu[0])[name]]
        for name in ("fields", "camera_opt")}


@pytest.mark.parametrize("kind", ["zero", "nonzero"])
def test_train_step_with_semantics_and_camera_matches_jax(kind):
    """One init-stage step with semantics (3 classes, weight 0.5) and
    SO3xR3, from zero tangents (the first step) or nonzero ones: every
    loss term, the gradients of the fields group (the semantics heads
    included) and of the camera tangents, and the updated tangents."""
    import jax.numpy as jnp
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.field import FieldConfig, params_from_jax

    over = dict(use_semantics=True, num_semantic_classes=3,
                camera_opt_mode="SO3xR3", mlp_dtype="float32")
    jcfg, params, statics, _ = tp.field_pair(**over)
    tang = tangents(kind, n=tp.N_CAMS, seed=1) * 0.2
    params = params.replace(camera_adjustment=jnp.asarray(tang))
    field = params_from_jax(params, statics,
                            FieldConfig(**tp.field_kwargs(**over)),
                            device="cpu")
    joct, toct = tp.octree_pair()
    batch = tp.train_batch()
    batch["semantics"] = (np.arange(tp.TRAIN_R) % 3).astype(np.int32)
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=tp.TRAIN_S,
               use_semantics=True, semantic_loss_weight=0.5)
    (jstate, _, jm, _), noise, perms = tp.jax_train_step(
        jcfg, params, statics, joct, batch, mkw, key_seed=5)
    state, _, tm, _ = tp.port_train_step(field, toct, batch, mkw, noise,
                                         perms)
    for k in ("loss", "rgb_loss", "s3im_loss", "semantics_loss",
              "camera_opt_regularizer", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    assert float(tm["semantics_loss"]) > 0.1
    groups = field_param_groups(field)
    jg = _jax_grads(jstate.opt_state)
    assert len(groups["fields"]) == len(jg["fields"])
    for name in ("fields", "camera_opt"):
        scale = max(float(np.abs(g).max()) for g in jg[name])
        for i, (p, want) in enumerate(zip(groups[name], jg[name])):
            assert p.grad is not None and torch.isfinite(p.grad).all()
            np.testing.assert_allclose(to_np(p.grad), want, rtol=1e-3,
                                       atol=1e-3 * scale,
                                       err_msg=f"{name}[{i}]")
    assert float(field.camera_adjustment.grad.abs().max()) > 0
    # the semantics loss trains the heads alone: the last semantics weight's
    # gradient is nonzero, and the tangents moved by one Adam step
    n_sem = 8
    sem = groups["fields"][-n_sem:]
    assert all(float(p.grad.abs().max()) > 0 for p in sem)
    np.testing.assert_allclose(to_np(field.camera_adjustment),
                               np.asarray(jstate.params.camera_adjustment),
                               rtol=0, atol=2e-6)
    assert not np.array_equal(to_np(field.camera_adjustment), tang)
    assert state.opt_state.count == 1


@pytest.fixture
def road_scene(tmp_path):
    """tests/test_train_smoke.py's scene: 8 views at 24x16 with binary
    road masks, the lower half of each image class 1."""
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path / "scene"
    make_synthetic_npz(path, n_train=8, n_val=2, img_wh=(24, 16))
    for split in ("train", "val"):
        d = dict(np.load(path / f"{split}.npz"))
        n, h, w = d["images"].shape[:3]
        masks = np.zeros((n, h, w), np.float32)
        masks[:, h // 2:, :] = 1.0
        d["road_masks"] = masks
        np.savez(path / f"{split}.npz", **d)
    return path


def tiny_trainer(path, tmp_path, steps, **pipeline):
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer

    cfg = get_method("gf-nerf-tiny")
    cfg.max_num_iterations = steps
    cfg.output_dir = tmp_path / "out"
    cfg.data, cfg.device = path, "cpu"
    cfg.steps_per_save = 10 ** 9
    cfg.pipeline.datamanager.train_num_rays_per_batch = 64
    cfg.pipeline.model.s3im_patch_height = 8
    for k, v in pipeline.items():
        if k in ("use_semantics", "semantic_loss_weight"):
            setattr(cfg.pipeline.model, k, v)
        else:
            setattr(cfg.pipeline, k, v)
    trainer = Trainer(cfg, build_dataparser("minimal", path))
    trainer.setup()
    return trainer


def test_road_masks_are_the_batches_labels(road_scene):
    """The road masks reach the port's batches as int32 labels, equal to
    the JAX package's, pixel for pixel (the same sampler draws)."""
    from gfnerf_tpu.data.datamanager import GFNerfDataManager as JaxDM
    from gfnerf_tpu.data.datamanager import (
        GFNerfDataManagerConfig as JaxDMConfig)
    from gfnerf_tpu_torch.data.datamanager import (GFNerfDataManager,
                                                   GFNerfDataManagerConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser

    kw = dict(train_num_rays_per_batch=64, steps_perssampler_init=10)
    jdm = JaxDM(JaxDMConfig(**kw), tp.jax_minimal_parser(road_scene), seed=1)
    dm = GFNerfDataManager(GFNerfDataManagerConfig(**kw),
                           build_dataparser("minimal", road_scene), seed=1)
    for step in range(3):
        jb, b = jdm.next_train(step), dm.next_train(step)
        assert b["semantics"].dtype == np.int32
        np.testing.assert_array_equal(b["semantics"], jb["semantics"])
        np.testing.assert_array_equal(b["semantics"],
                                      (b["indices"][:, 1] >= 8).astype(int))


def test_semantic_training_path(road_scene, tmp_path):
    """use_semantics: the labels flow from the npz through the cache to a
    finite cross-entropy term of the train step (test_train_smoke.py's
    test_semantic_training_path)."""
    trainer = tiny_trainer(road_scene, tmp_path, 3, use_semantics=True,
                           semantic_loss_weight=0.5)
    m = trainer.pipeline.get_train_loss_dict(0)
    assert "semantics_loss" in m
    assert np.isfinite(m["semantics_loss"]) and m["semantics_loss"] > 0.1


def test_camera_optimizer_path(road_scene, tmp_path):
    """camera_opt_mode=SO3xR3: the tangents move at the init stage, stay
    bit-unchanged at the focal stage (their updates are masked), and the
    regularizer is a loss term (test_train_smoke.py's
    test_camera_optimizer_path)."""
    trainer = tiny_trainer(road_scene, tmp_path, 14,
                           camera_opt_mode="SO3xR3")
    p = trainer.pipeline
    assert p.field.camera_adjustment is not None
    for step in range(10):
        m = p.get_train_loss_dict(step)
        p.after_train_iteration(step)
    assert "camera_opt_regularizer" in m
    after_init = to_np(p.field.camera_adjustment).copy()
    assert np.abs(after_init).max() > 0, "poses did not move in init stage"
    for step in range(10, 14):
        p.get_train_loss_dict(step)
        p.after_train_iteration(step)
    np.testing.assert_array_equal(to_np(p.field.camera_adjustment),
                                  after_init)
    # the focal steps' fresh optimizer state: no gradient reached them
    assert p.state.opt_state.mu["camera_opt"] == [None]
