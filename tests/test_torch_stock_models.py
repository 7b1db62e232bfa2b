"""The port's static-scene families against the JAX package's on the CPU:
the encodings (``fields/encodings.py``), mip-NeRF's integrated positional
encoding and conical frustums, vanilla NeRF and mip-NeRF
(``models/nerfacto.py``), TensoRF (``models/tensorf.py``) and NeuS
(``models/neus.py``): each family's forward, loss and parameter gradients
at cut widths, in training (the JAX package's draws handed over) and in
eval; NeuS's normals and eikonal term; the losses still missing before
(the scale-and-shift-invariant depth loss, the orientation and
predicted-normal losses); a few ``VanillaPipeline`` steps per family
against the JAX pipeline's; ``get_method`` for all 13 methods.

Parameters are drawn by each package's ``init_*_params`` from one seed
(the same numpy bits) and carried across by the ``params_from_jax``
functions; rays and targets are numpy draws.  Tolerances, and why:
- the frequency encoding 1e-6 (measured 6e-8: sin and cos of f32
  arguments in two libraries); random Fourier features 1e-4 (measured
  5.3e-5: the matrix product's arguments reach ~600, where an f32 ulp is
  6e-5);
- the IPE and frustum Gaussians: where the damping exp(-0.5 4^j sigma^2)
  keeps 1e-3 of the amplitude, 1e-5 absolute; beyond it the arguments
  reach 2^15 |mu| and the two libraries' sines may differ by more than
  an ulp, but the damping shrinks that below 1e-5;
- forward outputs (rgb, accumulation, depth, weights) 1e-5 of their
  largest (XLA:CPU contracts products into multiply-adds in the jitted
  forward, the port rounds each);
- losses 1e-5 relative; gradients 1e-3 of each tensor's largest (the
  MLPs' sums in other orders; TensoRF's plane gradients are scatter-adds
  in another order);
- the pipelines over their steps: the losses and PSNR 2e-4 relative
  (measured 1.3e-5, vanilla-nerf; after the first update Adam moves by
  about its learning rate the entries whose gradients nearly cancel,
  test_torch_pipeline's finding); the eval PSNR 2e-4 relative (measured
  4.2e-5).
- measured at these sizes: forward outputs 6.6e-6 of their largest
  (vanilla-nerf's fine weights), gradients 5.4e-5 of a tensor's largest
  (vanilla-nerf's fine first layer).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)

R = 16
FWD_TOL = 1e-5
GRAD_TOL = 1e-3
SMALL = {
    "vanilla-nerf": dict(num_coarse_samples=8, num_importance_samples=12,
                         pos_frequencies=6, dir_frequencies=2, hidden_dim=32),
    "mipnerf": dict(num_coarse_samples=8, num_importance_samples=12,
                    num_frequencies=8, dir_frequencies=2, hidden_dim=32),
    "tensorf": dict(resolution=16, density_channels=4, appearance_channels=6,
                    appearance_dim=9, num_coarse_samples=8,
                    num_fine_samples=12, hidden_dim=16),
    "neus": dict(num_samples=12, pos_frequencies=4, dir_frequencies=2,
                 hidden_dim=32, geo_feat_dim=8),
}


def rays(seed=0, n=R):
    """Rays from a ring of radius 4 toward the origin (the Blender
    fixture's cameras), jittered; targets in [0, 1]."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(ang), 4 * np.sin(ang),
                  rng.uniform(0.5, 1.5, n)], -1)
    d = -o + rng.normal(0, 0.3, o.shape)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tgt = rng.uniform(0, 1, (n, 3))
    area = rng.uniform(1e-5, 1e-4, (n, 1))
    return [x.astype(np.float32) for x in (o, d, tgt, area)]


def jax_draws(kind, key, n_rays=R):
    """The uniform draws a JAX forward takes from ``key``, in its key
    order: vanilla-nerf, mipnerf and tensorf split it in two (the coarse
    stratification, the resampling), neus takes one."""
    import jax

    small = SMALL[kind]
    if kind == "neus":
        return [np.array(jax.random.uniform(
            key, (n_rays, small["num_samples"] + 1)))]
    k1, k2 = jax.random.split(key)
    fine = small.get("num_importance_samples", small.get("num_fine_samples"))
    return [np.array(jax.random.uniform(
                k1, (n_rays, small["num_coarse_samples"] + 1))),
            np.array(jax.random.uniform(k2, (n_rays, fine + 1)))]


def family(kind):
    """(JAX module's loss, JAX forward, JAX init, JAX config, port loss,
    port forward, port model from JAX params, port config)."""
    from gfnerf_tpu.models import nerfacto as jnf
    from gfnerf_tpu.models import neus as jneus
    from gfnerf_tpu.models import tensorf as jtrf
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import neus as tneus
    from gfnerf_tpu_torch.models import tensorf as ttrf

    small = SMALL[kind]
    if kind == "vanilla-nerf":
        return (jnf.vanilla_loss, jnf.vanilla_forward,
                jnf.init_vanilla_params, jnf.VanillaNerfConfig(**small),
                tnf.vanilla_loss, tnf.vanilla_forward,
                tnf.vanilla_params_from_jax, tnf.VanillaNerfConfig(**small))
    if kind == "mipnerf":
        return (jnf.mipnerf_loss, jnf.mipnerf_forward,
                jnf.init_mipnerf_params, jnf.MipNerfConfig(**small),
                tnf.mipnerf_loss, tnf.mipnerf_forward,
                tnf.mipnerf_params_from_jax, tnf.MipNerfConfig(**small))
    if kind == "tensorf":
        return (jtrf.tensorf_loss, jtrf.tensorf_forward,
                jtrf.init_tensorf_params, jtrf.TensoRFConfig(**small),
                ttrf.tensorf_loss, ttrf.tensorf_forward,
                ttrf.params_from_jax, ttrf.TensoRFConfig(**small))
    return (jneus.neus_loss, jneus.neus_forward, jneus.init_neus_params,
            jneus.NeuSConfig(**small), tneus.neus_loss, tneus.neus_forward,
            tneus.params_from_jax, tneus.NeuSConfig(**small))


def flat_leaves(tree, prefix=""):
    """A JAX params tree's leaves by the port's parameter names
    (``coarse.mlp1.w.0``, ``den_planes.2``, ``inv_s``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def test_frequency_encodings_match_jax():
    """``nerf_frequency_encode`` at the families' frequency counts (with
    and without the input) and ``rff_encode`` on ``init_rff_matrix``'s
    matrix, which is the JAX package's bit for bit."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import encodings as J
    from gfnerf_tpu_torch.fields import encodings as T

    x = np.random.default_rng(0).uniform(-3, 3, (500, 3)).astype(np.float32)
    for n, include in ((10, True), (4, False), (6, True), (16, True)):
        want = jax.jit(lambda x: J.nerf_frequency_encode(
            x, n, 0.0, n - 1, include_input=include))(jnp.asarray(x))
        got = T.nerf_frequency_encode(torch.as_tensor(x), n, 0.0, n - 1,
                                      include_input=include)
        assert got.shape == want.shape == (500, 3 * 2 * n + 3 * include)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # the JAX package's own case (tests/test_components.py)
    enc = T.nerf_frequency_encode(torch.tensor([[0.5, 0.25, 0.0]]), 4, 0.0,
                                  3, include_input=True)
    assert enc.shape == (1, 3 + 3 * 4 * 2) and torch.isfinite(enc).all()
    b = T.init_rff_matrix(np.random.default_rng(1), 3, 8)
    np.testing.assert_array_equal(b, np.asarray(J.init_rff_matrix(
        np.random.default_rng(1), 3, 8)))
    want = jax.jit(J.rff_encode)(jnp.asarray(x), jnp.asarray(b))
    got = T.rff_encode(torch.as_tensor(x), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_ipe_and_frustum_match_jax():
    """The conical frustums' Gaussians of 16 bins on 16 rays at the train
    radius and the eval radius (1e-3), and their IPE at 16 frequencies:
    means and covariances 1e-5 relative; the encoding 1e-5 absolute."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfacto as J
    from gfnerf_tpu_torch.models import nerfacto as T

    o, d, _, area = rays(1)
    edges = np.sort(np.random.default_rng(2).uniform(2, 6, (R, 17)),
                    axis=1).astype(np.float32)
    bs, be = edges[:, :-1], edges[:, 1:]
    for radius in (np.sqrt(area[:, 0]) / 1.7320508,
                   np.full(R, 1e-3)):
        radius = radius.astype(np.float32)
        jm, jc = jax.jit(J.conical_frustum_gaussian)(*map(jnp.asarray, (
            o, d, bs, be, radius)))
        tm, tc = T.conical_frustum_gaussian(*map(torch.as_tensor, (
            o, d, bs, be, radius)))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-12)
        want = jax.jit(J.integrated_pos_enc, static_argnums=2)(jm, jc, 16)
        got = T.integrated_pos_enc(torch.as_tensor(np.array(jm)),
                                   torch.as_tensor(np.array(jc)), 16)
        assert got.shape == (R, 16, 16 * 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    # the eval cones (radius 1e-3) keep more of the high frequencies
    # than the train cones
    assert float(np.abs(np.asarray(want)[..., -6:]).max()) >= 0


@functools.lru_cache(maxsize=None)
def jax_run(kind, train, seed=0):
    """The jitted JAX loss, its gradients and the forward's outputs."""
    import jax
    import jax.numpy as jnp

    jloss, jfwd, jinit, jcfg, *_ = family(kind)
    params = jinit(jcfg, seed=seed)
    o, d, tgt, area = (jnp.asarray(x) for x in rays(seed))
    key = jax.random.PRNGKey(3)
    extra = dict(pixel_area=area) if kind == "mipnerf" else {}

    def loss(p):
        total, (losses, out) = jloss(p, jcfg, key if train else None, o, d,
                                     tgt, train=train, **extra)
        return total, (losses, out)

    (total, (losses, out)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return params, total, losses, out, grads


def port_run(kind, train, seed=0):
    import jax

    *_, tloss, tfwd, from_jax, tcfg = family(kind)
    params = jax_run(kind, train, seed)[0]
    model = from_jax(params, tcfg, device="cpu")
    o, d, tgt, area = (torch.as_tensor(x) for x in rays(seed))
    draws = ([torch.as_tensor(x) for x in jax_draws(kind,
                                                    jax.random.PRNGKey(3))]
             if train else None)
    extra = dict(pixel_area=area) if kind == "mipnerf" else {}
    total, (losses, out) = tloss(model, o, d, tgt, draws=draws, **extra)
    total.backward()
    return model, total, losses, out


def _levels(kind, out):
    return ([out["coarse"], out["fine"]] if kind in ("vanilla-nerf",
                                                      "mipnerf") else [out])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["vanilla-nerf", "mipnerf", "tensorf",
                                  "neus"])
def test_family_forward_loss_and_grads_match_jax(kind, train):
    """The family's loss, its parts, its outputs at every level and every
    parameter's gradient against the JAX package's, in training (the JAX
    package's draws handed over) and in eval (no jitter)."""
    _, jtotal, jlosses, jout, jgrads = jax_run(kind, train)
    model, total, losses, out = port_run(kind, train)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    for level, (t, j) in enumerate(zip(_levels(kind, out),
                                       _levels(kind, jout))):
        for k in ("rgb", "accumulation", "depth", "weights"):
            close(t[k].detach().numpy(), j[k], FWD_TOL, f"{level} {k}")
    assert float(_levels(kind, out)[-1]["accumulation"].max()) > 0.05
    want = flat_leaves(jgrads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        g = want[name]
        scale = float(np.abs(g).max())
        if scale == 0:
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("kind", ["vanilla-nerf", "mipnerf", "tensorf",
                                  "neus"])
def test_init_params_match_jax(kind):
    """``init_*_params`` of one seed: the JAX package's bits."""
    _, _, jinit, jcfg, *_ = family(kind)
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import neus as tneus
    from gfnerf_tpu_torch.models import tensorf as ttrf

    tinit = {"vanilla-nerf": tnf.init_vanilla_params,
             "mipnerf": tnf.init_mipnerf_params,
             "tensorf": ttrf.init_tensorf_params,
             "neus": tneus.init_neus_params}[kind]
    tcfg = family(kind)[-1]
    want = flat_leaves(jinit(jcfg, seed=4))
    got = flat_leaves(tinit(tcfg, seed=4))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_neus_eikonal_and_normals():
    """NeuS's SDF gradient against the JAX package's ``jax.grad`` of its
    SDF (1e-5 of the largest), without a graph in eval; the rendered
    normals and the eikonal term against the JAX package's
    (1e-5); and second order: the eikonal term alone moves the SDF MLP's
    weights, not the colour MLP's."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import neus as J
    from gfnerf_tpu_torch.models import neus as T

    params, _, _, jout, _ = jax_run("neus", False)
    jcfg, cfg = family("neus")[3], family("neus")[-1]
    model = T.params_from_jax(params, cfg, device="cpu")
    pts = np.random.default_rng(3).uniform(-1.5, 1.5, (64, 3)).astype(
        np.float32)
    want = jax.jit(jax.vmap(jax.grad(
        lambda p: J.sdf_fn(params, jcfg, p[None])[0][0])))(jnp.asarray(pts))
    pts = torch.as_tensor(pts)
    with torch.no_grad():
        sdf, _, grad = T.sdf_and_gradient(model, pts)
    assert not grad.requires_grad and not sdf.requires_grad
    close(grad.numpy(), want, 1e-5, "sdf gradient")
    o, d, _, _ = (torch.as_tensor(x) for x in rays(0))
    with torch.no_grad():
        out = T.neus_forward(model, o, d)
    close(out["normals"].numpy(), jout["normals"], FWD_TOL, "normals")
    np.testing.assert_allclose(float(out["eikonal"]), float(jout["eikonal"]),
                               rtol=1e-5)
    assert not out["normals"].requires_grad
    out = T.neus_forward(model, o, d)
    out["eikonal"].backward()
    assert float(model.sdf_mlp.w[0].grad.abs().max()) > 0
    assert model.color_mlp.w[0].grad is None


def test_losses_match_jax():
    """``scale_and_shift_invariant_depth_loss`` (with an image whose mask
    is empty), ``orientation_loss`` and ``pred_normal_loss`` against the
    JAX package's, 1e-5 relative."""
    import jax.numpy as jnp
    from gfnerf_tpu.model_components import losses as J
    from gfnerf_tpu_torch.model_components import losses as T

    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 2, (3, 8, 6)).astype(np.float32)
    tgt = (2.5 * pred + 0.3 + rng.normal(0, 0.05, pred.shape)).astype(
        np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.3).astype(np.float32)
    mask[2] = 0
    w = rng.uniform(0, 0.2, (16, 12)).astype(np.float32)
    n = rng.normal(size=(16, 12, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pn = rng.normal(size=(16, 12, 3)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    for name, args in (("scale_and_shift_invariant_depth_loss",
                        (pred, tgt, mask)),
                       ("orientation_loss", (w, n, v)),
                       ("pred_normal_loss", (w, n, pn))):
        want = getattr(J, name)(*map(jnp.asarray, args))
        got = getattr(T, name)(*map(torch.as_tensor, args))
        assert float(want) > 0, name
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=name)


def test_mipnerf_eval_cones_have_radius_1e3_as_in_jax():
    """The reference-side trait the port keeps: the JAX pipeline's render
    passes no pixel area, so eval cones have radius 1e-3 while training
    cones take sqrt(pixel area) / sqrt(3); the port's eval equals the
    JAX eval render, and differs from a render at the train radius."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfacto as J
    from gfnerf_tpu_torch.models import nerfacto as T

    params = jax_run("mipnerf", False)[0]
    jcfg, tcfg = family("mipnerf")[3], family("mipnerf")[-1]
    model = T.mipnerf_params_from_jax(params, tcfg, device="cpu")
    o, d, _, area = rays(0)
    # the JAX pipeline's render (vanilla_pipeline.py:132-133)
    want = jax.jit(lambda p, o, d: J.mipnerf_forward(
        p, jcfg, jax.random.PRNGKey(0), o, d, train=False)["fine"])(
            params, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = T.mipnerf_forward(model, torch.as_tensor(o),
                                torch.as_tensor(d))["fine"]
        cone = T.mipnerf_forward(model, torch.as_tensor(o),
                                 torch.as_tensor(d),
                                 pixel_area=torch.as_tensor(area))["fine"]
    close(got["rgb"].numpy(), want["rgb"], FWD_TOL, "rgb")
    assert float((cone["rgb"] - got["rgb"]).abs().max()) > 1e-4
    np.testing.assert_allclose(
        T.cone_radius(None, 4, "cpu").numpy(), np.full(4, 1e-3, np.float32))


# ---- the vanilla pipeline ----

PIPE_STEPS = 4
PIPE_RAYS = 32


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """A Blender scene of 6 + 2 RGB PNGs at 24x16 (ring radius 4)."""
    from gfnerf_tpu_torch.utils.synthetic import make_blender_fixture

    path = tmp_path_factory.mktemp("stock") / "scene"
    make_blender_fixture(path, 6, 2, img_wh=(24, 16))
    return path


def small_pipeline(cfg, kind):
    """``cfg`` (either package's VanillaPipelineConfig) cut to the small
    model of ``kind``."""
    cfg.train_num_rays_per_batch = PIPE_RAYS
    cfg.eval_num_rays_per_chunk = 96
    sub = getattr(cfg, {"vanilla-nerf": "vanilla"}.get(kind, kind))
    for k, v in SMALL[kind].items():
        setattr(sub, k, v)
    return cfg


@pytest.mark.parametrize("kind", ["vanilla-nerf", "mipnerf", "tensorf",
                                  "neus"])
def test_vanilla_pipeline_matches_jax(blender_scene, tmp_path, kind):
    """PIPE_STEPS steps of the port's VanillaPipeline against the JAX
    package's on the same Blender scene, seed and batches, each step's
    draws taken from the JAX pipeline's key chain (mipnerf's cones from
    the rays' pixel area); then the eval PSNR (fine level, eval cones of
    radius 1e-3)."""
    import jax
    from gfnerf_tpu.data.dataparsers.blender_parser import (
        BlenderDataParser, BlenderDataParserConfig)
    from gfnerf_tpu.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig as JaxConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    jcfg = small_pipeline(JaxConfig(model_kind=kind), kind)
    jpipe = jcfg.build(BlenderDataParser(BlenderDataParserConfig(
        data=blender_scene)), tmp_path / "jax")
    rng, keys = jax.random.PRNGKey(jcfg.seed), []
    for _ in range(PIPE_STEPS):
        rng, key = jax.random.split(rng)
        keys.append(key)
    pcfg = small_pipeline(VanillaPipelineConfig(model_kind=kind), kind)
    pipe = pcfg.build(build_dataparser("blender", blender_scene),
                      tmp_path / "port", "cpu",
                      draws=lambda step, r: jax_draws(kind, keys[step], r))
    jm = [jpipe.get_train_loss_dict(i) for i in range(PIPE_STEPS)]
    tm = [pipe.get_train_loss_dict(i) for i in range(PIPE_STEPS)]
    assert pipe.state.step == PIPE_STEPS
    for i, (a, b) in enumerate(zip(tm, jm)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4,
                                       err_msg=f"step {i} {k}")
    want = jpipe.get_eval_image_metrics_and_images(PIPE_STEPS)[0]
    got, images = pipe.get_eval_image_metrics_and_images(PIPE_STEPS)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=2e-4)
    assert images["img"].shape == (16, 48, 3)


def test_pipeline_checkpoint_round_trip(blender_scene, tmp_path):
    """TensoRF's planes and lines keep their list names in the
    checkpoint's state dict, and a reloaded pipeline renders the same
    eval image."""
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    cfg = small_pipeline(VanillaPipelineConfig(model_kind="tensorf"),
                         "tensorf")
    parser = build_dataparser("blender", blender_scene)
    pipe = cfg.build(parser, tmp_path / "a", "cpu")
    for step in range(2):
        pipe.get_train_loss_dict(step)
    (tmp_path / "ckpt").mkdir()
    pipe.save_checkpoint_state(tmp_path / "ckpt", 1)
    names = set(torch.load(tmp_path / "ckpt" / "state.pt",
                           weights_only=True)["model"])
    assert {f"{g}.{i}" for g in ("den_planes", "den_lines", "app_planes",
                                 "app_lines") for i in range(3)} <= names
    other = cfg.build(parser, tmp_path / "b", "cpu")
    assert other.load_checkpoint_state(tmp_path / "ckpt") == 1
    a = pipe.get_eval_image_metrics_and_images(2)[1]["img"]
    b = other.get_eval_image_metrics_and_images(2)[1]["img"]
    np.testing.assert_array_equal(a, b)


def test_get_method_all_thirteen():
    """Every method the JAX package registers gives a config of its name
    (the nerfplayer pair's too, now ported): none raises "not ported"."""
    from gfnerf_tpu.configs.method_configs import method_configs
    from gfnerf_tpu_torch.configs.method_configs import get_method

    assert len(method_configs) == 13
    for name in method_configs:
        assert get_method(name).method_name == name
    assert get_method("nerfplayer-ngp").pipeline.model_kind == \
        "nerfplayer-ngp"
